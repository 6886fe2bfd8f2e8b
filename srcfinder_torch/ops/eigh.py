"""Batched symmetric eigensolve of small matrices: CUDA kernel + plain version.

``symeig(M)`` returns the eigenvalues, ascending, and the eigenvectors, as
columns, of every symmetric matrix of a batch ``M`` (..., B, B), reading
its lower triangle, as ``torch.linalg.eigh`` does. A matrix that holds a
non-finite value gets NaN eigenvalues (and an identity V), as the JAX
package's eigh gives them, so the CMF's cond gate catches its column
instead of raising. It routes by where ``M`` lies and by its shape:

- a CPU tensor: ``torch.linalg.eigh`` with that non-finite guard;
- a CUDA tensor whose A and V fit one block's shared memory (:func:`fits`:
  B <= 168 in float32, <= 118 in float64; the CMF's CH4 radiance window
  has 72 bands, CO2's 82): ``csrc/syevj.cu`` (built for ``sm_90a`` at
  first use), one launch a batch, raising if it cannot;
- a CUDA tensor of a larger B (reflectance's 415-band window):
  ``torch.linalg.eigh`` with the guard, counted in :func:`library_calls`
  beside the kernel's :func:`launches`.

The kernel replaces no TPU kernel: the JAX package's eigh is XLA's, and
the port called cuSOLVER's batched Jacobi through ``torch.linalg.eigh``,
which launches its sweeps from the host. :func:`syevj_ref` is the
kernel's iteration in plain PyTorch (the same pair order, threshold,
stopping rule and sort) for the tests and ``chip_smoke.py``; the main
path never runs it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .build import CudaKernel

__all__ = ["symeig", "syevj", "syevj_ref", "fits", "smem_bytes", "launches",
           "library_calls", "reset", "MAX_SWEEPS", "KERNEL"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = [_P] * 4 + [_I64, _I, _P]
KERNEL = CudaKernel("syevj.cu", {"srcf_syevj_f32": _SIG, "srcf_syevj_f64": _SIG})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: csrc/syevj.cu: the sweep cap of each precision (Prec<T>::max_sweeps)
#: and the shared memory a block may use
MAX_SWEEPS = {torch.float32: 32, torch.float64: 48}
SMEM_MAX = 232_448
# theta^2 + 1 stays finite below it (Prec<T>::big)
_BIG = {torch.float32: 1e18, torch.float64: 1e150}

_lock = threading.Lock()
_library = 0


def smem_bytes(B: int, dtype) -> int:
    """Dynamic shared memory of one block for a B x B matrix
    (csrc/syevj.cu ``smem_bytes``): A and V^T, N x (N + 1) each with N = B
    rounded up to even, the rotations' s and tau, and three int arrays of
    the pairs and the sort."""
    N = B + (B & 1)
    return dtype.itemsize * (2 * N * (N + 1) + N) + 8 * N


def fits(B: int, dtype) -> bool:
    """Whether the kernel takes B x B matrices of ``dtype``."""
    return dtype in _SUFFIX and B >= 1 and smem_bytes(B, dtype) <= SMEM_MAX


def _guarded_eigh(M):
    """``torch.linalg.eigh`` of a batch that may hold non-finite matrices:
    those get NaN eigenvalues (their V is the identity's), in place of an
    error or garbage."""
    bad = ~torch.isfinite(M).flatten(-2).all(dim=-1)
    if not bad.any():
        return torch.linalg.eigh(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    lam, V = torch.linalg.eigh(torch.where(bad[..., None, None], eye, M))
    return torch.where(bad[..., None], torch.full_like(lam, float("nan")), lam), V


def syevj(M):
    """The kernel on a CUDA batch ``M`` (C, B, B), contiguous, float32 or
    float64. Returns (lam (C, B) ascending, V (C, B, B), sweeps (C,) int32:
    the sweeps each matrix ran, 0 for a non-finite one)."""
    if M.device.type != "cuda":
        raise ValueError(f"syevj: needs a CUDA tensor, got one on {M.device}")
    if M.dtype not in _SUFFIX:
        raise TypeError(f"syevj: dtype {M.dtype} not supported")
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"syevj: M must be (C, B, B), got {tuple(M.shape)}")
    if not M.is_contiguous():
        raise ValueError("syevj: M must be contiguous")
    C, B, _ = M.shape
    if not fits(B, M.dtype):
        raise ValueError(f"syevj: {B} x {B} {M.dtype} matrices do not fit a block's "
                         f"shared memory ({smem_bytes(B, M.dtype)} > {SMEM_MAX} bytes)")
    lam = torch.empty(C, B, dtype=M.dtype, device=M.device)
    V = torch.empty(C, B, B, dtype=M.dtype, device=M.device)
    sweeps = torch.empty(C, dtype=torch.int32, device=M.device)
    if C == 0:
        return lam, V, sweeps
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        KERNEL.launch(f"srcf_syevj_{_SUFFIX[M.dtype]}", M.data_ptr(), lam.data_ptr(),
                      V.data_ptr(), sweeps.data_ptr(), C, B, stream)
    return lam, V, sweeps


def symeig(M):
    """Eigenvalues (ascending) and eigenvectors (columns) of a batch of
    symmetric matrices (..., B, B): the guarded ``torch.linalg.eigh`` on
    the CPU, the kernel on a card where :func:`fits` allows, else the
    guarded ``torch.linalg.eigh`` there too (counted)."""
    global _library
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"symeig: M must be (..., B, B), got {tuple(M.shape)}")
    if M.device.type == "cpu":
        return _guarded_eigh(M)
    if M.device.type != "cuda":
        raise ValueError(f"symeig: unsupported device {M.device}")
    B = M.shape[-1]
    if not fits(B, M.dtype):
        with _lock:
            _library += 1
        return _guarded_eigh(M)
    lead = M.shape[:-2]
    lam, V, _ = syevj(M.reshape(-1, B, B).contiguous())
    return lam.reshape(*lead, B), V.reshape(*lead, B, B)


def launches() -> int:
    """Kernel launches since the last :func:`reset`."""
    return KERNEL.launches


def library_calls() -> int:
    """CUDA batches too large for the kernel, solved by
    ``torch.linalg.eigh``, since the last :func:`reset`."""
    return _library


def reset() -> None:
    """Zero :func:`launches` and :func:`library_calls`."""
    global _library
    KERNEL.reset()
    with _lock:
        _library = 0


def _pairs(N: int):
    """The round-robin order of an even N: (N - 1, N/2) tensors p and q,
    step k pairing (N - 1, k) and ((k + P) mod (N - 1), (k - P) mod
    (N - 1)) for P = 1 .. N/2 - 1."""
    m = N - 1
    k = torch.arange(m)[:, None]
    P = torch.arange(1, N // 2)[None, :]
    p = torch.cat([torch.full((m, 1), m), (k + P) % m], dim=1)
    q = torch.cat([k, (k - P) % m], dim=1)
    return p, q


def syevj_ref(M):
    """The kernel's iteration in plain PyTorch on a batch ``M`` (C, B, B),
    float32 or float64, on any device: the lower triangle mirrored, the
    round-robin pairs, Rutishauser's rotations with the relative skip
    threshold, applied as corrections (x - s (y + tau x)), the blocks above
    the block diagonal rotated rows first and mirrored, the stop after a
    quiet sweep or at ``MAX_SWEEPS``, the ascending sort with ties by
    index. Returns (lam, V, sweeps) as
    :func:`syevj` does."""
    dt, dev = M.dtype, M.device
    C, B, _ = M.shape
    N = B + (B & 1)
    eps = torch.finfo(dt).eps
    big = _BIG[dt]
    bad = ~torch.isfinite(M).flatten(1).all(dim=1)
    A = torch.tril(M) + torch.tril(M, -1).mT
    A = torch.nn.functional.pad(torch.where(bad[:, None, None], 0.0, A), (0, N - B, 0, N - B))
    Vt = torch.eye(N, dtype=dt, device=dev).repeat(C, 1, 1)
    pp, qq = _pairs(N)
    # which pair each index belongs to at each step: (N - 1, N)
    owner = torch.empty(N - 1, N, dtype=torch.long)
    steps = torch.arange(N - 1)[:, None]
    owner[steps, pp] = torch.arange(N // 2)
    owner[steps, qq] = torch.arange(N // 2)
    pp, qq, owner = pp.to(dev), qq.to(dev), owner.to(dev)
    active = ~bad
    sweeps = torch.zeros(C, dtype=torch.int32, device=dev)
    cols = torch.arange(C, device=dev)[:, None]
    for _ in range(MAX_SWEEPS[dt]):
        if not active.any():
            break
        fired_any = torch.zeros(C, dtype=torch.bool, device=dev)
        for k in range(N - 1):
            p, q = pp[k], qq[k]
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]            # (C, N/2)
            fire = (apq.abs() > eps * app.abs().sqrt() * aqq.abs().sqrt()) & active[:, None]
            if not fire.any():
                continue
            fired_any |= fire.any(dim=1)
            theta = (aqq - app) / (2.0 * torch.where(fire, apq, 1.0))
            at = theta.abs()
            t = torch.where(at < big, 1.0 / (at + torch.sqrt(1.0 + at * at)), 0.5 / at)
            t = torch.where(fire, torch.where(theta < 0, -t, t), 0.0)
            c = torch.where(fire, 1.0 / torch.sqrt(1.0 + t * t), 1.0)
            s = t * c
            tau = s / (1.0 + c)
            # rows, then columns, of J^T A J, each rotation as a correction
            sr, tr = s[..., None], tau[..., None]
            Ap, Aq = A[:, p, :], A[:, q, :]
            A = A.clone()
            A[:, p, :] = Ap - sr * (Aq + tr * Ap)
            A[:, q, :] = Aq + sr * (Ap - tr * Aq)
            sc, tc = s[:, None, :], tau[:, None, :]
            Ap, Aq = A[:, :, p], A[:, :, q]
            A[:, :, p] = Ap - sc * (Aq + tc * Ap)
            A[:, :, q] = Aq + sc * (Ap - tc * Aq)
            # the blocks above the block diagonal, mirrored below it
            o = owner[k]
            A = torch.where(o[:, None] < o[None, :], A, A.mT)
            # the diagonal blocks, by Rutishauser's formulas
            A[cols, p, p] = torch.where(fire, app - t * apq, app)
            A[cols, q, q] = torch.where(fire, aqq + t * apq, aqq)
            A[cols, p, q] = A[cols, q, p] = torch.where(fire, 0.0, apq)
            Vp, Vq = Vt[:, p, :], Vt[:, q, :]
            Vt = Vt.clone()
            Vt[:, p, :] = Vp - sr * (Vq + tr * Vp)
            Vt[:, q, :] = Vq + sr * (Vp - tr * Vq)
        sweeps += active.to(torch.int32)
        active &= fired_any
    diag = torch.diagonal(A, dim1=1, dim2=2)[:, :B]
    lam, perm = torch.sort(diag, dim=1, stable=True)
    V = torch.gather(Vt[:, :B, :B], 1, perm[:, :, None].expand(C, B, B)).mT
    lam = torch.where(bad[:, None], float("nan"), lam)
    V = torch.where(bad[:, None, None], torch.eye(B, dtype=dt, device=dev), V)
    return lam, V, sweeps
