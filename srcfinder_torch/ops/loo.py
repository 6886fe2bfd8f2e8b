"""LOOCV alpha sweep of the CMF: CUDA kernel + plain version.

``loo_sweep(Z, inv_glam, beta, m)`` returns, per column and shrinkage
alpha, the masked line sum of ``log q + r / q`` and the flag "q > 0 on
every valid line" (see :func:`loo_sweep_ref`). For a tensor on the CPU
it runs the plain PyTorch version; for a CUDA tensor it launches
``csrc/loo.cu`` (built for ``sm_90a`` at first use), which never writes
the (L, C, A) intermediate, and raises if it cannot. The plain version
is the (L, C, A) part of the JAX package's ``cmf/matched_filter.py::_loo_nll``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

__all__ = ["loo_sweep", "loo_sweep_ref", "KERNEL"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _I64, _I64, _I64, _P]
KERNEL = CudaKernel("loo.cu", {"srcf_loo_sweep_f32": _SIG,
                               "srcf_loo_sweep_f64": _SIG})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def loo_sweep_ref(Z, inv_glam, beta, m):
    """Z: (L, C, B) whitened rotated data, inv_glam: (C, B, A),
    beta: (C, A), m: (L, C). Returns ssum (C, A), q_ok (C, A) bool."""
    r = torch.einsum("lcb,cba->lca", Z * Z, inv_glam)            # (L, C, A)
    q = 1.0 - beta[None, :, :] * r
    q_ok = ((q > 0) | ~(m[:, :, None] > 0)).all(dim=0)
    safe_q = torch.where(q > 0, q, torch.ones_like(q))
    per = torch.log(safe_q) + r / safe_q
    ssum = torch.einsum("lc,lca->ca", m.to(Z.dtype), per)
    return ssum, q_ok


def loo_sweep(Z, inv_glam, beta, m):
    """:func:`loo_sweep_ref` on the CPU, the CUDA kernel on a card."""
    if Z.device.type == "cpu":
        return loo_sweep_ref(Z, inv_glam, beta, m)
    if Z.device.type != "cuda":
        raise ValueError(f"loo_sweep: unsupported device {Z.device}")
    if Z.dtype not in _SUFFIX:
        raise TypeError(f"loo_sweep: dtype {Z.dtype} not supported")
    if Z.dim() != 3:
        raise ValueError(f"loo_sweep: Z must be (L, C, B), got {tuple(Z.shape)}")
    L, C, B = Z.shape
    A = inv_glam.shape[-1]
    if tuple(inv_glam.shape) != (C, B, A) or tuple(beta.shape) != (C, A):
        raise ValueError("loo_sweep: inv_glam must be (C, B, A) and beta (C, A)")
    if tuple(m.shape) != (L, C):
        raise ValueError("loo_sweep: m must be (L, C)")
    for t in (inv_glam, beta, m):
        if t.device != Z.device:
            raise ValueError("loo_sweep: all inputs must be on one device")
    if Z.stride(2) != 1:
        Z = Z.contiguous()
    inv_glam = inv_glam.to(Z.dtype).contiguous()
    beta = beta.to(Z.dtype).contiguous()
    m = m.to(Z.dtype)
    ssum = torch.empty(C, A, dtype=Z.dtype, device=Z.device)
    q_ok = torch.empty(C, A, dtype=torch.uint8, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        KERNEL.launch(f"srcf_loo_sweep_{_SUFFIX[Z.dtype]}",
                      Z.data_ptr(), inv_glam.data_ptr(), beta.data_ptr(),
                      m.data_ptr(), ssum.data_ptr(), q_ok.data_ptr(),
                      L, C, B, A, Z.stride(0), Z.stride(1), m.stride(0),
                      m.stride(1), stream)
    return ssum, q_ok.bool()
