"""Spectrometer QC masks (reference: spectrometer_masks/masks_sds.py).

The public names are the JAX package's ``masks``'s; they load on first
use, as ``core``'s and ``flow``'s do.
"""

from .._lazy import lazy_names as _lazy_names

_NAMES = {
    "sds": ("MaskParams", "pixel_masks", "grow_flare_mask", "dilate_mask", "masks_for_cube",
            "get_radius_in_pixels"),
}
__getattr__, __dir__, __all__ = _lazy_names(__name__, _NAMES)
