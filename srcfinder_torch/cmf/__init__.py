"""Columnwise robust matched filter (CMF) (reference: cmf/robust_mf.py).

The public names are the JAX package's ``cmf``'s; they load on first use,
as ``core``'s and ``flow``'s do.
"""

from .._lazy import lazy_names as _lazy_names

_NAMES = {
    "matched_filter": ("PPM_SCALING", "ACTIVE_RANGES", "default_alphas", "valid_mask",
                       "masked_moments", "MFResult", "matched_filter_columns",
                       "mf_column_stats"),
}
__getattr__, __dir__, __all__ = _lazy_names(__name__, _NAMES)
