"""Plain columnwise multimodal (cluster-tuned) matched filter, for the check
of the multimodal CMF product (srcfinder's ``cmf/robust_mf.py -k K -r``;
Funk et al. 2001, IEEE TGRS 39:1410).

Per detector column, over its valid pixels (every active band finite and
>= 0), with B active bands:

1. the mean and the ddof=1 covariance, its eigenvectors, and the pixels'
   zero-mean spectra projected onto the top ``pcadim`` of them by
   descending eigenvalue;
2. Lloyd's k-means on the projections to a fixed point (at most
   ``iters`` iterations), started from the mean projection of each
   planted class in the column (``classes``, the configuration's class
   map, and not the program's seeds); a cluster left empty keeps its
   centroid;
3. a mode of fewer than int((B - 1) * 1.2) pixels is rejected when
   ``reject`` is set, unless every mode of the column is;
4. per mode, its mean mu and ddof=1 covariance S, and the shrinkage alpha
   chosen from 10^(-10..0) step 0.05 by Theiler's leave-one-out
   likelihood as in ``reference/cmf.py``, with the full column's valid
   count n in beta = (1 - alpha) / (n - 1) and in 1 / (2 n) and the sum
   over the mode's pixels (robust_mf.py:355-356);
5. the filter of the mode's pixels with C = (1 - alpha) S + alpha diag(S)
   and the target t = absorption * mu, in ppm*m after x 1e5.

The pixels of a rejected mode, and invalid pixels, carry no estimate.
Where it follows the port's recorded departures from robust_mf.py: mode 0
can be rejected like any other (robust_mf.py's sign flip of the labels
keeps label 0, :322); each mode keeps its own estimate (robust_mf.py's
pooled pass over the non-rejected pixels can overwrite them, :340,
:381-386); k-means is Lloyd's iteration (robust_mf.py uses
MiniBatchKMeans), here from the planted classes.

Columns are taken in blocks; ``dtype`` and ``rounding`` (applied to every
matrix product's operands) give the control its lower precision.
"""

from __future__ import annotations

import math

import torch

from .cmf import PPM, _mm, alphas


def _fit(xb, mk, n, absorption, a, rounding):
    """One mode's filter (c, L) of every column of the block: xb (c, L, B)
    the zeroed invalid spectra, mk (c, L) the mode's pixels, n (c,) the
    full column's valid count."""
    dtype, B = xb.dtype, xb.shape[2]
    nk = mk.sum(dim=1)
    mu = (xb * mk[:, :, None]).sum(dim=1) / nk.clamp(min=1)[:, None]
    xc = (xb - mu[:, None, :]) * mk[:, :, None]
    S = _mm(xc.transpose(1, 2), xc, rounding) / (nk - 1).clamp(min=1)[:, None, None]
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
    q_ok = ((q > 0) | (mk[:, :, None] == 0)).all(dim=1)
    qs = torch.where(q > 0, q, torch.ones_like(q))
    loo = ((torch.log(qs) + r / qs) * mk[:, :, None]).sum(dim=1)
    nll = (0.5 * (B * math.log(2 * math.pi) + 2 * torch.log(d).sum(dim=1)[:, None]
                  + torch.log(g).sum(dim=1)) + loo / (2 * n.clamp(min=1))[:, None])
    nll = torch.where(g_ok & q_ok, nll, torch.full_like(nll, math.inf))
    best = nll.min(dim=1)
    alpha = torch.where(torch.isfinite(best.values), a[best.indices],
                        torch.zeros((), dtype=dtype, device=xb.device))
    clam = ((1 - alpha)[:, None] * lam + alpha[:, None]).clamp(min=1e-30)
    tw = _mm((absorption[None, :] * mu)[:, None, :], W, rounding)[:, 0]   # W^T t
    y = tw / clam
    mf = _mm(Z, y[:, :, None], rounding)[:, :, 0] / (tw * y).sum(dim=1)[:, None]
    return torch.where((mk > 0) & (nk >= 2)[:, None], mf, torch.zeros_like(mf))


def _lloyd(z, m, cent, iters):
    """Labels (c, L) of Lloyd's iteration from ``cent`` (c, K, P) to a fixed
    point, or after ``iters`` updates."""
    K = cent.shape[1]
    lab = ((z[:, :, None, :] - cent[:, None]) ** 2).sum(dim=-1).argmin(dim=2)
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(lab, K).to(z.dtype) * m[:, :, None]
        cnt = onehot.sum(dim=1)                                   # (c, K)
        sums = torch.einsum("clk,clp->ckp", onehot, z)
        cent = torch.where((cnt > 0)[:, :, None], sums / cnt.clamp(min=1)[:, :, None], cent)
        new = ((z[:, :, None, :] - cent[:, None]) ** 2).sum(dim=-1).argmin(dim=2)
        if torch.equal(new[m > 0], lab[m > 0]):
            break
        lab = new
    return lab


def matched_filter_multimodal(x, absorption, classes, k, pcadim=6, reject=True,
                              dtype=torch.float64, rounding=None, block=64, iters=100):
    """x: (L, C, B) active-window radiance on its device; absorption: (B,);
    classes: (L, C) planted class ids 0..k-1, each present among every
    column's valid pixels. Returns (ppm*m (L, C) in ``dtype``, estimate
    given (L, C) bool, mode (L, C) int64, -1 where invalid)."""
    L, C, B = x.shape
    dev = x.device
    a = alphas(dtype, dev)
    absorption = torch.as_tensor(absorption, dtype=dtype, device=dev)
    classes = torch.as_tensor(classes, device=dev).long()
    valid = torch.isfinite(x).all(dim=2) & (x >= 0).all(dim=2)
    minsamp = int((B - 1) * 1.2)
    out = torch.zeros(L, C, dtype=dtype, device=dev)
    given = torch.zeros(L, C, dtype=torch.bool, device=dev)
    modes = torch.full((L, C), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, C, block):
        xb = x[:, c0:c0 + block].to(dtype).permute(1, 0, 2)          # (c, L, B)
        m = valid[:, c0:c0 + block].T.to(dtype)                       # (c, L)
        xb = torch.where(m[:, :, None] > 0, xb, torch.zeros((), dtype=dtype, device=dev))
        n = m.sum(dim=1)
        mu = xb.sum(dim=1) / n.clamp(min=1)[:, None]
        xc = (xb - mu[:, None, :]) * m[:, :, None]
        S = _mm(xc.transpose(1, 2), xc, rounding) / (n - 1).clamp(min=1)[:, None, None]
        _, V = torch.linalg.eigh(S)
        z = _mm(xc, V.flip(-1)[:, :, :pcadim], rounding)              # (c, L, P)
        planted = torch.nn.functional.one_hot(classes[:, c0:c0 + block].T, k).to(dtype) \
            * m[:, :, None]                                           # (c, L, K)
        per_class = planted.sum(dim=1)
        if (per_class == 0).any():
            raise ValueError("a planted class has no valid pixel in a column")
        cent = torch.einsum("clk,clp->ckp", planted, z) / per_class[:, :, None]
        lab = _lloyd(z, m, cent, iters)
        onehot = torch.nn.functional.one_hot(lab, k).to(dtype) * m[:, :, None]
        cnt = onehot.sum(dim=1)                                       # (c, K)
        rej = cnt < minsamp if reject else torch.zeros_like(cnt, dtype=torch.bool)
        rej = rej & ~rej.all(dim=1, keepdim=True)
        mf = torch.zeros_like(m)
        for j in range(k):
            mk = onehot[:, :, j]
            use = (mk > 0) & ~rej[:, j:j + 1]
            mf = torch.where(use, _fit(xb, mk, n, absorption, a, rounding), mf)
            given[:, c0:c0 + block] |= use.T
        out[:, c0:c0 + block] = mf.T * PPM
        modes[:, c0:c0 + block] = torch.where(m > 0, lab, torch.full_like(lab, -1)).T
    return out, given, modes
