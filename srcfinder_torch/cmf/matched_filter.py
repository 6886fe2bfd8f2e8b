"""Columnwise robust matched filter (unimodal) in PyTorch.

Port of the JAX package's ``cmf/matched_filter.py``. With shrinkage target
``T = diag(diag(S))`` (reference: robust_mf.py:99), write ``D =
sqrt(diag(S))`` and ``R = D^-1 S D^-1 = V diag(lam) V^T``. For every
alpha in Theiler's closed-form LOOCV (Theiler, "The Incredible Shrinking
Covariance Estimator", Proc. SPIE 2012, eq. 29):

    G_a        = n*beta*S + alpha*T = D (n*beta*R + alpha*I) D
    logdet G_a = 2*sum(log d) + sum_i log(n*beta*lam_i + alpha)
    r_k(a)     = z_k^T diag(1/(n*beta*lam + alpha)) z_k,  z_k = V^T D^-1 x_k

so the 201-alpha sweep is elementwise work on eigenvalues plus one
(L, B) x (B, A) product per column, and the final covariance shares the
eigenbasis. Two steps are hand-written CUDA kernels on a card
(:mod:`srcfinder_torch.ops`): the masked moments and the (L, C, A) part
of the sweep. The whitening and the MF apply are plain batched matmuls.

Ragged columns (per-column valid-pixel subsets, robust_mf.py:282) are
handled with mask-weighted moments on fixed shapes. The multimodal
background (robust_mf.py:306-397) fits one such model per (column, mode)
with the mode's mask, so both kernels run once per mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.loo import loo_sweep
from ..ops.moments import masked_moments

__all__ = [
    "PPM_SCALING", "ACTIVE_RANGES", "default_alphas", "valid_mask",
    "masked_moments", "MFResult", "matched_filter_columns", "MFMultimodalResult",
    "matched_filter_columns_multimodal", "mf_column_stats",
]

#: matched-filter score -> ppm*m (reference: robust_mf.py:38)
PPM_SCALING = 100000.0

#: active channel windows, 1-based inclusive-exclusive as in the reference
#: (reference: robust_mf.py:185-194)
ACTIVE_RANGES = {
    ("ch4", False): (351, 422),
    ("ch4", True): (5, 420),     # reflectance
    ("co2", False): (309, 391),
}


def default_alphas(dtype=np.float64) -> np.ndarray:
    """alpha grid 10^(-10..0) step 0.05 -> 201 points
    (reference: robust_mf.py:242-243)."""
    astep, aminexp, amaxexp = 0.05, -10.0, 0.0
    return (10.0 ** np.arange(aminexp, amaxexp + astep, astep)).astype(dtype)


def valid_mask(x):
    """Rows usable for covariance: all active bands finite and non-negative
    (reference: robust_mf.py:282 ``useidx``).

    x: (..., B) -> bool (...)
    """
    return torch.all(torch.isfinite(x) & ~(x < 0), dim=-1)


class MFResult(NamedTuple):
    mf: torch.Tensor           # (L, C) matched-filter scores
    alpha_index: torch.Tensor  # (C,) argmin index into alphas (-1 => fallback)
    nll: torch.Tensor          # (C, A) LOOCV negative log likelihoods
    mu: torch.Tensor           # (C, B) background means
    n: torch.Tensor            # (C,) valid-pixel counts
    cond: torch.Tensor         # (C,) lam_min/lam_max of the whitened cov;
    #                            f32 is trustworthy down to ~1e-6, below
    #                            that the pipeline recomputes in f64


def _loo_nll(lam, Z, logdiag, n, m, alphas, nchan):
    """Theiler eq.29 LOOCV nll for all alphas at once, in the eigenbasis.

    lam: (C, B) eigenvalues of the whitened covariance; Z: (L, C, B)
    whitened, rotated, zero-mean data; logdiag: (C, B) log of the whitener
    diagonal (log d, or log diag(chol T)); n: (C,) the count behind beta =
    (1-a)/(n-1) and the 1/(2n) normalisation, the full column's valid
    count even for a mode's fit (robust_mf.py:355-356, :110); m: (L, C)
    the rows summed (the mode's mask); alphas: (A,). Returns nll: (C, A).
    """
    dt = Z.dtype
    beta = (1.0 - alphas)[None, :] / torch.clamp(n - 1.0, min=1.0)[:, None]
    nb = n[:, None] * beta                                          # (C, A)
    glam = nb[:, None, :] * lam[:, :, None] + alphas[None, None, :]  # (C, B, A)
    glam_ok = torch.all(glam > 0, dim=1)                            # (C, A)
    safe_glam = torch.where(glam > 0, glam, torch.ones_like(glam))
    logdet = (2.0 * torch.sum(logdiag, dim=1)[:, None]
              + torch.sum(torch.log(safe_glam), dim=1))             # (C, A)

    ssum, q_ok = loo_sweep(Z, 1.0 / safe_glam, beta, m)             # (C, A)

    nchanlog2pi = nchan * torch.log(torch.tensor(2.0 * math.pi, dtype=dt,
                                                 device=Z.device))
    nll = (0.5 * (nchanlog2pi + logdet)
           + ssum / (2.0 * torch.clamp(n, min=1.0))[:, None])
    return torch.where(glam_ok & q_ok, nll, torch.full_like(nll, math.inf))


def _eigh(M):
    """``torch.linalg.eigh`` of a batch that may hold non-finite matrices
    (a failed Cholesky of a near-singular f32 target): those get NaN
    eigenvalues, as the JAX package's eigh gives them, so their columns
    fail the cond gate instead of raising."""
    bad = ~torch.isfinite(M).all(dim=2).all(dim=1)
    if not bad.any():
        return torch.linalg.eigh(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    lam, V = torch.linalg.eigh(torch.where(bad[:, None, None], eye, M))
    return torch.where(bad[:, None], torch.full_like(lam, math.nan), lam), V


def _cholesky_whitener(S, T):
    """Whitener for a full shrinkage target T: ``Lc = chol(T + 1e-12 I)``,
    ``M = Lc^-1 S Lc^-T`` symmetrised, ``M = V diag(lam) V^T``. Returns
    (lam, Wmat = Lc^-T V, logdiag = log diag Lc). A target that is not
    positive definite gives NaN, as in the JAX package."""
    B = S.shape[-1]
    Lc, info = torch.linalg.cholesky_ex(
        T + 1e-12 * torch.eye(B, dtype=S.dtype, device=S.device))
    Lc = torch.where((info != 0)[:, None, None], torch.full_like(Lc, math.nan), Lc)
    LiS = torch.linalg.solve_triangular(Lc, S, upper=False)
    M = torch.linalg.solve_triangular(Lc, LiS.mT, upper=False).mT
    lam, V = _eigh(0.5 * (M + M.mT))
    Wmat = torch.linalg.solve_triangular(Lc.mT, V, upper=True)
    logdiag = torch.log(torch.clamp(torch.diagonal(Lc, dim1=1, dim2=2), min=1e-300))
    return lam, Wmat, logdiag


def matched_filter_columns(x, m, abscf, alphas, model: str = "looshrinkage",
                           reflectance: bool = False, T=None,
                           n_loo=None) -> MFResult:
    """Robust matched filter over all columns simultaneously.

    x:      (L, C, B) active-window radiance (columns = detector samples)
    m:      (L, C) valid mask (see :func:`valid_mask`), or a mode's mask
    abscf:  (B,) target gas signature over the active window
    alphas: (A,) shrinkage grid (ignored for model='empirical')
    T:      optional (C, B, B) full shrinkage target (the reference's
            ``regfull``, robust_mf.py:99, :353-356); None shrinks toward
            ``diag(diag(S))``
    n_loo:  optional (C,) count for the LOOCV (beta and 1/(2n)); the
            multimodal fit passes the full column's valid count while the
            moments come from the mode's rows (robust_mf.py:355-356);
            None uses the mask's count

    All tensors on one device, in one float dtype. ``mf`` is in MF-score
    units; invalid pixels have mf=0 and are stamped with nodata by the
    caller (robust_mf.py:266).
    """
    dt = x.dtype
    L, C, B = x.shape
    # zero out invalid rows with where (not multiplication: NaN * 0 = NaN)
    mbool = m.to(torch.bool)
    x = torch.where(mbool[:, :, None], x, torch.zeros((), dtype=dt, device=x.device))
    m = m.to(dt)
    n, mu, S = masked_moments(x, m)
    ok = n >= 2.0

    if T is None:
        # whitener = D = sqrt(diag(S)); whitened covariance = correlation
        diag = torch.diagonal(S, dim1=1, dim2=2)                # (C, B)
        d = torch.sqrt(torch.clamp(diag, min=1e-30))            # (C, B)
        Rw = S / (d[:, :, None] * d[:, None, :])
        lam, V = torch.linalg.eigh(Rw)                          # (C,B),(C,B,B)
        Wmat = V / d[:, :, None]                                # D^-1 V
        logdiag = torch.log(torch.clamp(d, min=1e-300))
    else:
        lam, Wmat, logdiag = _cholesky_whitener(S, T)

    xc = (x - mu[None, :, :]) * m[:, :, None]                   # zero-mean valid
    Zc = torch.bmm(xc.permute(1, 0, 2), Wmat)                   # (C, L, B)
    Z = Zc.permute(1, 0, 2)                                     # (L, C, B) view

    if model == "looshrinkage":
        nll = _loo_nll(lam, Z, logdiag, n if n_loo is None else n_loo,
                       m, alphas, B)                            # (C, A)
        mindex = torch.argmin(nll, dim=1)                       # (C,)
        has_min = torch.isfinite(torch.min(nll, dim=1).values)
        alpha = torch.where(has_min, alphas[mindex], torch.zeros((), dtype=dt, device=x.device))
        mindex = torch.where(has_min, mindex, torch.full_like(mindex, -1))
    elif model == "empirical":
        alpha = torch.zeros(C, dtype=dt, device=x.device)
        mindex = torch.zeros(C, dtype=torch.int64, device=x.device)
        nll = torch.zeros(C, alphas.shape[0], dtype=dt, device=x.device)
    else:
        raise ValueError(f"unknown model {model!r}")

    # final covariance C = (1-a)S + aT shares the eigenbasis:
    # C^-1 = Wmat diag(1/((1-a)lam + a)) Wmat^T
    clam = (1.0 - alpha)[:, None] * lam + alpha[:, None]        # (C, B)
    clam = torch.where(clam > 1e-30, clam, torch.full_like(clam, 1e-30))

    # target: t = abscf * mu (radiance) or abscf - mu (reflectance)
    # (reference: robust_mf.py:378-379)
    t = (abscf[None, :] - mu) if reflectance else (abscf[None, :] * mu)
    tw = torch.bmm(t[:, None, :], Wmat)[:, 0, :]                # Wmat^T t
    normalizer = torch.sum(tw * tw / clam, dim=1)               # (C,)
    y = tw / clam                                               # (C, B)
    mf = (torch.bmm(Zc, y[:, :, None])[:, :, 0].T
          / torch.clamp(normalizer, min=1e-300)[None, :])       # (L, C)

    zero = torch.zeros((), dtype=dt, device=x.device)
    mf = torch.where(m > 0, mf, zero) * torch.where(ok, 1.0, 0.0).to(dt)[None, :]
    cond = torch.clamp(lam[:, 0], min=0.0) / torch.clamp(lam[:, -1], min=1e-300)
    return MFResult(mf=mf, alpha_index=mindex, nll=nll, mu=mu,
                    n=n.to(torch.int32), cond=cond)


class MFMultimodalResult(NamedTuple):
    mf: torch.Tensor         # (L, C)
    valid: torch.Tensor      # (L, C) bool: pixel has an (unrejected) estimate
    labels: torch.Tensor     # (L, C) int32 mode ids
    alpha_pix: torch.Tensor  # (L, C) int32 per-pixel alpha index
    rejected: torch.Tensor   # (C, K) bool rejected modes
    cond: torch.Tensor       # (C, K) per-mode condition of the whitened cov
    counts: torch.Tensor     # (C, K) per-mode valid-pixel counts


def matched_filter_columns_multimodal(x, m, abscf, alphas, bgmodes: int,
                                      pcadim: int = 6, reject: bool = False,
                                      regfull: bool = False,
                                      model: str = "looshrinkage",
                                      reflectance: bool = False,
                                      kmeans_iters: int = 25, seed: int = 0,
                                      init_index=None) -> MFMultimodalResult:
    """Multimodal background MF: PCA + k-means partitions of each column,
    one covariance model per (column, mode) (reference:
    robust_mf.py:306-397). ``init_index`` (C, K) seeds k-means with those
    rows instead of k-means++ (see :func:`.kmeans.kmeans_columns`).

    Modes with fewer than ``int((B - 1) * 1.2)`` samples are rejected when
    ``reject`` is set (robust_mf.py:199-200, :321-324) and their pixels
    carry no estimate; a column whose modes are all rejected keeps them
    all (robust_mf.py:330-332). Each mode's looshrinkage uses the full
    column's valid count (robust_mf.py:355-356) while its moments come
    from the mode's rows. ``regfull`` shrinks toward the full column's
    covariance (robust_mf.py:353-356).

    Recorded deviations from the reference, as in the JAX package: mode 0
    can be rejected like any other (the reference flips label signs and
    -0 == 0, robust_mf.py:322); every mode keeps its own estimate (the
    reference's pooled pass over the non-rejected pixels can overwrite
    them, robust_mf.py:340, :381-386); k-means is Lloyd's iteration from
    k-means++ seeds (the reference uses MiniBatchKMeans).
    """
    from .kmeans import kmeans_columns, masked_pca_project

    dt = x.dtype
    mbool = m.to(torch.bool)
    x = torch.where(mbool[:, :, None], x, torch.zeros((), dtype=dt, device=x.device))
    m = m.to(dt)
    B = x.shape[2]
    z = masked_pca_project(x, m, pcadim)
    labels, _ = kmeans_columns(z, m, bgmodes, iters=kmeans_iters, seed=seed,
                               init_index=init_index)

    # int((active[1]-active[0]) * 1.2) in the reference: one less than the
    # band count (robust_mf.py:199-200)
    bgminsamp = int((B - 1) * 1.2)
    onehot = (torch.nn.functional.one_hot(labels.long(), bgmodes).to(dt)
              * m[:, :, None])                                  # (L, C, K)
    cnt = onehot.sum(dim=0)                                     # (C, K)
    rej = (cnt < bgminsamp) if reject else torch.zeros_like(cnt, dtype=torch.bool)
    rej = rej & ~rej.all(dim=1)[:, None]

    Tfull = masked_moments(x, m)[2] if regfull else None
    n_full = m.sum(dim=0)                                       # the reference's nuse

    mf = torch.zeros_like(m)
    alpha_pix = torch.full(m.shape, -1, dtype=torch.int32, device=x.device)
    valid = torch.zeros_like(mbool)
    conds = []
    for k in range(bgmodes):
        mask_k = mbool & (labels == k)
        res_k = matched_filter_columns(x, mask_k.to(dt), abscf, alphas, model=model,
                                       reflectance=reflectance, T=Tfull, n_loo=n_full)
        use_k = mask_k & ~rej[:, k][None, :]
        mf = torch.where(use_k, res_k.mf, mf)
        alpha_pix = torch.where(use_k, res_k.alpha_index.to(torch.int32)[None, :], alpha_pix)
        valid = valid | use_k
        conds.append(res_k.cond)
    return MFMultimodalResult(mf=mf, valid=valid, labels=labels, alpha_pix=alpha_pix,
                              rejected=rej, cond=torch.stack(conds, dim=1), counts=cnt)


def mf_column_stats(mf_ppmm, m, nodata=-9999.0):
    """Per-column npix/avg/std of the MF image over valid pixels
    (reference: robust_mf.py:388-392, columns with no valid pixels keep
    nodata)."""
    m = m.to(mf_ppmm.dtype)
    n = m.sum(dim=0)
    ok = n > 0
    avg = torch.einsum("lc,lc->c", m, mf_ppmm) / torch.clamp(n, min=1.0)
    var = (torch.einsum("lc,lc->c", m, (mf_ppmm - avg[None, :]) ** 2)
           / torch.clamp(n, min=1.0))
    std = torch.sqrt(var)
    nod = torch.full_like(n, nodata)
    return (torch.where(ok, n, nod), torch.where(ok, avg, nod),
            torch.where(ok, std, nod))
