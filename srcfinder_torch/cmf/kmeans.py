"""Batched masked PCA and k-means of the multimodal CMF background.

Port of the JAX package's ``cmf/kmeans.py`` (reference:
cmf/robust_mf.py:306-332): each column's zero-mean valid spectra are
projected onto their top ``pcadim`` principal axes, then clustered into
``k`` modes by Lloyd's iteration, all columns at once. The moments go
through the masked-moments kernel (K1) on a card; the rest is plain
batched torch (``eigh``, ``bmm``, one-hot counts), as XLA ran it for the
JAX package.

Recorded deviations, as in the JAX package: the top ``pcadim`` axes by
descending eigenvalue (the reference slices unordered ``eig`` output,
robust_mf.py:310-311), and deterministic Lloyd's iteration from
k-means++ seeds in place of MiniBatchKMeans. The seeds come from a
``torch.Generator`` seeded by ``seed``: torch cannot reproduce
``jax.random.gumbel``, so the same seed draws other seeds than the JAX
package does; ``init_index`` passes seeds in explicitly.
"""

from __future__ import annotations

import math

import torch

from ..ops.moments import masked_moments

__all__ = ["masked_pca_project", "kmeans_columns"]


def masked_pca_project(x, m, pcadim: int):
    """Project each column's valid spectra onto its top principal axes.

    x: (L, C, B) data (invalid rows already zeroed), m: (L, C) mask.
    Returns z: (L, C, pcadim).
    """
    m = m.to(x.dtype)
    _, mu, S = masked_moments(x, m)
    _, V = torch.linalg.eigh(S)                         # ascending eigenvalues
    Vtop = V.flip(-1)[:, :, :pcadim]                    # (C, B, P) descending
    xc = (x - mu[None, :, :]) * m[:, :, None]
    return torch.bmm(xc.permute(1, 0, 2), Vtop).permute(1, 0, 2)


def _take_rows(z, idx):
    """Rows ``idx`` (C, K) of each column of z (L, C, P) -> (C, K, P)."""
    cols = torch.arange(z.shape[1], device=z.device)[:, None]
    return z[idx, cols]


def _kpp_init(z, m, k: int, gen):
    """k-means++ seeds of every column, by gumbel-max sampling over that
    column's valid rows: the first uniformly, each next one with weight
    the squared distance to the column's nearest seed so far.

    z: (L, C, P), m: (L, C), gen: a torch.Generator on z's device.
    Returns the seeds' row indices (C, k).
    """
    L, C, _ = z.shape
    tiny = torch.finfo(z.dtype).tiny

    def gumbel():
        u = torch.rand((L, C), generator=gen, dtype=z.dtype, device=z.device)
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

    valid = m > 0
    neg_inf = torch.full((), -math.inf, dtype=z.dtype, device=z.device)
    idx = [torch.argmax(torch.where(valid, gumbel(), neg_inf), dim=0)]     # (C,)
    for _ in range(1, k):
        cent = _take_rows(z, torch.stack(idx, dim=1))                       # (C, K', P)
        d2 = ((z[:, :, None, :] - cent[None]) ** 2).sum(dim=-1).min(dim=2).values
        logits = torch.where(valid, torch.log(torch.clamp(d2, min=1e-30)), neg_inf)
        idx.append(torch.argmax(logits + gumbel(), dim=0))
    return torch.stack(idx, dim=1)


def _sq_dist(z, cent):
    """Squared distances (L, C, K) of every point to its column's
    centroids, in the JAX package's expanded form."""
    return ((z * z).sum(dim=-1)[:, :, None]
            - 2.0 * torch.einsum("lcp,ckp->lck", z, cent)
            + (cent * cent).sum(dim=-1)[None])


def kmeans_columns(z, m, k: int, iters: int = 25, seed: int = 0, init_index=None):
    """Lloyd's k-means per column on the masked points.

    z: (L, C, P), m: (L, C). ``init_index``: optional (C, k) row indices
    of the starting centroids; None draws k-means++ seeds from a
    ``torch.Generator`` seeded by ``seed``. A cluster left empty keeps
    its old centroid. Returns labels (L, C) int32 (arbitrary where ~m)
    and centroids (C, k, P).
    """
    m = m.to(z.dtype)
    if init_index is None:
        gen = torch.Generator(device=z.device).manual_seed(seed)
        init_index = _kpp_init(z, m, k, gen)
    cent = _take_rows(z, torch.as_tensor(init_index, device=z.device).long())
    for _ in range(iters):
        lab = torch.argmin(_sq_dist(z, cent), dim=2)                # (L, C)
        onehot = torch.nn.functional.one_hot(lab, k).to(z.dtype) * m[:, :, None]
        cnt = onehot.sum(dim=0)                                     # (C, K)
        sums = torch.einsum("lck,lcp->ckp", onehot, z)              # (C, K, P)
        newc = sums / torch.clamp(cnt, min=1.0)[:, :, None]
        cent = torch.where((cnt > 0)[:, :, None], newc, cent)
    labels = torch.argmin(_sq_dist(z, cent), dim=2).to(torch.int32)
    return labels, cent
