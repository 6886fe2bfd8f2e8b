"""Plume detection: FCN saliency, dense CNN saliency, the
salience-to-plume-list step, detection filtering and downsampling
(reference: cnn/cnn_pred_pipeline.py, cnn/fcn_pred_pipeline.py,
salience_predictions.py, srcfinder_util.py filtdet, cnn/posthoc_down.py).

The public names are the JAX package's ``detect``'s; they load on first
use, as ``core``'s and ``flow``'s do.
"""

import sys
import types

from .._lazy import lazy_names as _lazy_names

_NAMES = {
    "preprocess": ("preprocess_ch4", "norm_for_model"),
    "fcn_pipeline": ("fcn_shift_saliency", "fcn_phase_saliency", "fcn_phase_saliency_blocked",
                     "stitch_stack", "fcn_saliency_image"),
    "cnn_pipeline": ("cnn_window_saliency", "cnn_fast_saliency", "cnn_saliency_image"),
    "salience": ("salience2detections", "save_detections", "DETECTION_COLUMNS"),
    "filtdet": ("filtdet", "kde"),
    "posthoc_down": ("gaussian_downsample", "gkern", "get_pixsig"),
}
__getattr__, __dir__, __all__ = _lazy_names(__name__, _NAMES)


class _Package(types.ModuleType):
    """The function ``filtdet`` has its module's name, and loading a
    submodule binds it to the package's attribute of that name: keep the
    function there, as the JAX package's eager import does, without
    importing the module (and torch) for the host-only salience CLI."""

    def __setattr__(self, name, value):
        if name == "filtdet" and isinstance(value, types.ModuleType):
            value = value.filtdet
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
