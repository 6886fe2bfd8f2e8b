"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the
card; without one it raises unless the caller asked for ``"cpu"``. It
never falls back to the CPU by itself.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` and pin full-f32 arithmetic.

    TF32 is turned off for matmuls and for cuDNN convolutions: the CMF
    contractions and the FCN trunk are held to the f32 reference, and
    TF32 keeps only about three decimal digits (cuDNN's default is on).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
