"""srcfinder_torch: the PyTorch/CUDA port of the JAX package srcfinder-tpu.

One flightline runs radiance -> columnwise matched filter -> FCN
saliency -> plume list -> IME (``srcfinder_torch.flow.pipeline_cli``).
Entry points run on the CUDA device by default and raise without one
unless ``device="cpu"`` is passed. The package imports torch, numpy,
scipy and pandas only.
"""

__version__ = "0.1.0"
