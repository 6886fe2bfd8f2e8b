"""LOOCV alpha sweep of the CMF: CUDA kernel + plain version.

``loo_sweep(Z, inv_glam, beta, m)`` returns, per column and shrinkage
alpha, the masked line sum of ``log q + r / q`` and the flag "q > 0 on
every valid line" (see :func:`loo_sweep_ref`). For a tensor on the CPU
it runs the plain PyTorch version; for a CUDA tensor it launches
``csrc/loo.cu`` (built for ``sm_90a`` at first use), which never writes
the (L, C, A) intermediate, and raises if it cannot. The plain version
is the (L, C, A) part of the JAX package's ``cmf/matched_filter.py::_loo_nll``.

The kernel splits each column's lines over several blocks, each sweeping
all the alphas of its group: :func:`plan` chooses the split from the
shapes alone, and the wrapper allocates the per-split scratch that the
kernel's fixed-order combine reads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import CudaKernel

__all__ = ["loo_sweep", "loo_sweep_ref", "plan", "LooPlan", "KERNEL"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = ([_P] * 8 + [_I] * 4 + [_I64] * 4 + [_I] * 10 + [_P])
KERNEL = CudaKernel("loo.cu", {"srcf_loo_sweep_f32": _SIG,
                               "srcf_loo_sweep_f64": _SIG})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# csrc/loo.cu: lines per tile, ring stages, most bands per shared-memory
# chunk; per element type the threads per block, the alphas of one warp
# (f32 32, f64 16; a block's alphas are a multiple of it) and the most
# alphas per block; blocks the grid should reach (two per SM of an H100)
# and the shared memory a block may use
TILE_L, STAGES, MAX_KC = 64, 2, 96
THREADS = {torch.float32: 224, torch.float64: 416}
WARP_A = {torch.float32: 32, torch.float64: 16}
MAX_A = {torch.float32: 224, torch.float64: 208}
MIN_BLOCKS = 264
SMEM_MAX = 232_448


class LooPlan(NamedTuple):
    splits: int        # blocks along the lines of one column
    lines: int         # lines per split (a multiple of TILE_L); the last is short
    a_grp: int         # alphas per block: A padded to a multiple of WARP_A
    a_groups: int      # blocks along the alphas of one column
    kc: int            # bands per shared-memory chunk (a multiple of 4)
    nch: int           # chunks per line tile
    kstride: int       # shared row stride of a staged line (elements)
    istride: int       # shared row stride of ig (elements)
    threads: int       # threads per block
    smem: int          # dynamic shared memory per block (bytes)
    partial: tuple     # scratch shape of the per-split sums and flags


def _pad(n, k):
    return -(-n // k) * k


@functools.lru_cache(maxsize=64)
def plan(L, C, B, A, dtype) -> LooPlan:
    """Launch plan of the kernel for Z (L, C, B) and A alphas: a pure
    function of the shapes and the element type. Row strides are padded
    so the f64 tensor-core fragments read shared memory without bank
    conflicts; lines are split so the grid has at least MIN_BLOCKS blocks
    where the lines allow it."""
    size = dtype.itemsize
    nch = -(-_pad(B, 4) // MAX_KC)
    kc = _pad(-(-B // nch), 4)
    kstride = kc + 4 if kc % 16 in (0, 8) else kc
    ring = STAGES * TILE_L * (kstride + 1) * size     # staged lines and their masks
    step = WARP_A[dtype]
    a_grp = min(MAX_A[dtype], _pad(A, step))
    while True:
        istride = a_grp + 4
        # f32 also stages the group's beta
        smem = nch * kc * istride * size + ring + (a_grp * size if size == 4 else 0)
        if smem <= SMEM_MAX:
            break
        a_grp -= step
        if a_grp < step:
            raise ValueError(f"loo_sweep: {B} bands do not fit in shared memory")
    a_groups = -(-A // a_grp)
    ntile = -(-L // TILE_L)
    want = -(-MIN_BLOCKS // (C * a_groups))
    lines = max(1, ntile // want) * TILE_L
    splits = max(1, -(-L // lines))
    return LooPlan(splits, lines, a_grp, a_groups, kc, nch, kstride, istride,
                   THREADS[dtype], smem, (splits, C, A))


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
    p = plan(L, C, B, A, Z.dtype)
    # 16-byte copies of Z rows: aligned rows (a ragged last vector is
    # zero-filled by the copy)
    vw = 16 // Z.element_size()
    vec = int(Z.data_ptr() % 16 == 0 and Z.stride(0) % vw == 0
              and Z.stride(1) % vw == 0)
    ssum = torch.empty(C, A, dtype=Z.dtype, device=Z.device)
    q_ok = torch.empty(C, A, dtype=torch.uint8, device=Z.device)
    pss = torch.empty(p.partial, dtype=Z.dtype, device=Z.device)
    pok = torch.empty(p.partial, dtype=torch.uint8, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        KERNEL.launch(f"srcf_loo_sweep_{_SUFFIX[Z.dtype]}",
                      Z.data_ptr(), inv_glam.data_ptr(), beta.data_ptr(),
                      m.data_ptr(), ssum.data_ptr(), q_ok.data_ptr(),
                      pss.data_ptr(), pok.data_ptr(), L, C, B, A, Z.stride(0),
                      Z.stride(1), m.stride(0), m.stride(1), p.splits, p.lines,
                      p.a_grp, p.a_groups, p.kc, p.nch, p.kstride, p.istride,
                      vec, p.smem, stream)
    return ssum, q_ok.bool()
