"""CMF triage: column profiles and systematics detection
(reference: triage/cmf_profile.py, triage/COVID/*).

The public names are the JAX package's ``triage``'s. They load on first
use, so the systematics detector and the COVID oracle's report import no
torch; the column statistics (``profile``) run on the device.
"""

from .._lazy import lazy_names as _lazy_names

_NAMES = {
    "profile": ("column_stats", "summarize_cmf", "profile_files", "plot_stats",
                "ANG_NCOLS"),
    "systematics": ("systematics_count", "flag_systematics", "load_systematics_list",
                    "validate_systematics", "confusion_report"),
}
__getattr__, __dir__, __all__ = _lazy_names(__name__, _NAMES)
