"""TROPOMI flux inversion (toy) — OLS and Bayesian forms, on the device.

Reference (msf_flow/deployment/inversion-run/lambda_function.py:196-205):
x_hat = (H^T H)^-1 H^T (y - background) with background 1860 ppb;
Bayesian Rodgers-2000 form (inversion-run.py:61-116, also commented in
the Lambda): x_hat = x_a + S_a H^T (H S_a H^T + S_o)^-1 (y - H x_a).
Background estimation takes the 5th percentile per overpass time
(inversion-background.py:28-44).

Port of the JAX package's ``flow/inversion.py``, whose solves are
``jax.jit`` functions on its accelerator with 64-bit mode off: every input
is computed in float32, matmuls at full f32 precision. Here they are
cuBLAS products and cuSOLVER factorisations through ``torch.linalg`` on
``device`` (TF32 off, :func:`srcfinder_torch.device.resolve_device`), in
``dtype`` float32 unless the caller asks for float64. A factorisation that
fails (a matrix not positive definite, or singular) gives NaN or inf as
JAX's does, and raises nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ols_inversion", "bayesian_inversion", "posterior_covariance",
           "background_percentile"]


def _on(dev, dtype, *arrays):
    return [torch.as_tensor(a).to(device=dev, dtype=dtype) for a in arrays]


def _cho_solve(A, b):
    """Solve A x = b through the Cholesky factor of A. Where A is not
    positive definite the factor is NaN, so x is, as JAX's ``cho_factor``
    leaves it; ``cholesky_ex`` neither raises nor waits for the device."""
    L, info = torch.linalg.cholesky_ex(A)
    L.masked_fill_(info != 0, float("nan"))
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def ols_inversion(H, y, background=1860.0, device="cuda",
                  dtype=torch.float32):
    """x_hat = (H^T H)^-1 H^T (y - background); solved via Cholesky on the
    normal equations (reference: inversion-run lambda_function.py:196-205).
    Returns a tensor on ``device``."""
    H, y = _on(resolve_device(device), dtype, H, y)
    rhs = H.T @ (y - background)
    A = H.T @ H
    # small ridge keeps the toy problem solvable when columns are empty
    A = A + 1e-9 * torch.eye(A.shape[0], dtype=dtype, device=A.device)
    return _cho_solve(A, rhs)


def bayesian_inversion(H, y, x_a, S_a, S_o, device="cuda",
                       dtype=torch.float32):
    """Rodgers (2000) linear-Gaussian posterior mean:
    x_hat = x_a + S_a H^T (H S_a H^T + S_o)^-1 (y - H x_a)
    (reference: inversion-run.py:61-116). Returns a tensor on ``device``."""
    H, y, x_a, S_a, S_o = _on(resolve_device(device), dtype, H, y, x_a, S_a,
                              S_o)
    K = H @ S_a @ H.T
    K += S_o
    resid = y - H @ x_a
    return x_a + S_a @ H.T @ _cho_solve(K, resid)


def posterior_covariance(H, S_a, S_o, device="cuda", dtype=torch.float32):
    """Rodgers posterior covariance
    S_hat = (H^T S_o^-1 H + S_a^-1)^-1
    (reference: inversion-run.py:92-97 via sparse spsolve/inv), dense as
    the JAX package computes it. Returns a tensor on ``device``."""
    H, S_a, S_o = _on(resolve_device(device), dtype, H, S_a, S_o)
    A = H.T @ torch.linalg.solve_ex(S_o, H)[0] + torch.linalg.inv_ex(S_a)[0]
    return torch.linalg.inv_ex(A)[0]


def background_percentile(values, times, q: float = 5.0):
    """Per-overpass-time background as the q-th percentile
    (reference: inversion-background.py:28-44)."""
    values = np.asarray(values, np.float64)
    times = np.asarray(times)
    out = {}
    for t in np.unique(times):
        sel = values[times == t]
        sel = sel[np.isfinite(sel)]
        out[t] = float(np.percentile(sel, q)) if sel.size else np.nan
    return out
