"""GoogLeNet-1ch, its FCN head and the weight converter (reference:
cnn/archs/googlenet1.py, cnn/models/*).

The public names are the JAX package's ``models``'s; they load on first
use, as ``core``'s and ``flow``'s do.
"""

from .._lazy import lazy_names as _lazy_names

# the factory ``googlenet`` takes its module's name, as in the JAX package
from .googlenet import googlenet

_NAMES = {
    "googlenet": ("GoogLeNet", "CAMPAIGN_NORM", "clamp_ch4", "adaptive_avg_pool2d"),
    "convert": ("torch_state_dict_to_flax", "load_pt", "flax_to_torch_state_dict"),
    "fcn": ("fcn_apply", "fcn_saliency"),
}
__getattr__, __dir__, _LAZY = _lazy_names(__name__, _NAMES)
__all__ = ["googlenet", *_LAZY]
