"""Plain columnwise robust matched filter (unimodal), for the check of the
flightline's CMF product.

Per detector column: the background is the column's valid pixels (every
active band finite and >= 0), with mean mu and ddof=1 covariance S. The
shrinkage target is T = diag(S) and the shrinkage alpha is chosen from
10^(-10..0) step 0.05 by Theiler's closed-form leave-one-out likelihood
(Theiler, "The Incredible Shrinking Covariance Estimator", SPIE 2012,
eq. 29): with G = n beta S + alpha T, beta = (1 - alpha) / (n - 1),
r_k = x_k^T G^-1 x_k and q_k = 1 - beta r_k,

    nll(alpha) = (B log 2 pi + log det G) / 2 + sum_k (log q_k + r_k / q_k) / (2 n),

infinite where G or any q_k is not positive. The filter is the covariance
C = (1 - alpha) S + alpha T applied to the target t = absorption * mu:
mf_k = (x_k - mu)^T C^-1 t / (t^T C^-1 t), in ppm*m after x 1e5. Columns
with fewer than two valid pixels give 0; invalid pixels are nodata.

G and C share the eigenbasis of the correlation matrix R = D^-1 S D^-1
(D = sqrt(diag S)), so each is worked out from R's eigenpairs. Columns are
taken in blocks; ``dtype`` and ``rounding`` (applied to every matrix
product's operands) give the controls their lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PPM = 1e5


def alphas(dtype=torch.float64, device="cpu"):
    return torch.as_tensor(10.0 ** np.arange(-10.0, 0.0 + 0.05, 0.05), dtype=dtype,
                           device=device)


def _mm(a, b, rounding):
    return torch.matmul(rounding(a), rounding(b)) if rounding else torch.matmul(a, b)


def matched_filter(x, absorption, dtype=torch.float64, rounding=None, block=64):
    """x: (L, C, B) active-window radiance on its device; absorption: (B,).
    Returns (ppm*m (L, C) in ``dtype``, valid (L, C) bool)."""
    L, C, B = x.shape
    dev = x.device
    a = alphas(dtype, dev)
    absorption = torch.as_tensor(absorption, dtype=dtype, device=dev)
    valid = torch.isfinite(x).all(dim=2) & (x >= 0).all(dim=2)
    out = torch.zeros(L, C, dtype=dtype, device=dev)
    for c0 in range(0, C, block):
        xb = x[:, c0:c0 + block].to(dtype).permute(1, 0, 2)          # (c, L, B)
        m = valid[:, c0:c0 + block].T.to(dtype)                       # (c, L)
        xb = torch.where(m[:, :, None] > 0, xb, torch.zeros((), dtype=dtype, device=dev))
        n = m.sum(dim=1)                                              # (c,)
        mu = xb.sum(dim=1) / n.clamp(min=1)[:, None]
        xc = (xb - mu[:, None, :]) * m[:, :, None]
        S = _mm(xc.transpose(1, 2), xc, rounding) / (n - 1).clamp(min=1)[:, None, None]
        d = torch.sqrt(torch.diagonal(S, dim1=1, dim2=2).clamp(min=1e-30))
        lam, V = torch.linalg.eigh(S / (d[:, :, None] * d[:, None, :]))
        W = V / d[:, :, None]                                         # D^-1 V
        Z = _mm(xc, W, rounding)                                      # (c, L, B)
        beta = (1 - a)[None, :] / (n - 1).clamp(min=1)[:, None]       # (c, A)
        g = (n[:, None] * beta)[:, None, :] * lam[:, :, None] + a      # (c, B, A)
        g_ok = (g > 0).all(dim=1)
        g = torch.where(g > 0, g, torch.ones_like(g))
        r = _mm(Z * Z, 1.0 / g, rounding)                             # (c, L, A)
        q = 1 - beta[:, None, :] * r
        q_ok = ((q > 0) | (m[:, :, None] == 0)).all(dim=1)
        qs = torch.where(q > 0, q, torch.ones_like(q))
        loo = ((torch.log(qs) + r / qs) * m[:, :, None]).sum(dim=1)
        nll = (0.5 * (B * math.log(2 * math.pi) + 2 * torch.log(d).sum(dim=1)[:, None]
                      + torch.log(g).sum(dim=1)) + loo / (2 * n.clamp(min=1))[:, None])
        nll = torch.where(g_ok & q_ok, nll, torch.full_like(nll, math.inf))
        best = nll.min(dim=1)
        alpha = torch.where(torch.isfinite(best.values), a[best.indices],
                            torch.zeros((), dtype=dtype, device=dev))
        clam = ((1 - alpha)[:, None] * lam + alpha[:, None]).clamp(min=1e-30)
        tw = _mm((absorption[None, :] * mu)[:, None, :], W, rounding)[:, 0]   # W^T t
        y = tw / clam
        mf = _mm(Z, y[:, :, None], rounding)[:, :, 0] / (tw * y).sum(dim=1)[:, None]
        mf = torch.where((m > 0) & (n >= 2)[:, None], mf, torch.zeros_like(mf))
        out[:, c0:c0 + block] = mf.T * PPM
    return out, valid
