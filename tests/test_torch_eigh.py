"""The CMF's batched symmetric eigensolve (``srcfinder_torch.ops.eigh``):
the plain Jacobi iteration (``syevj_ref``) held to numpy's float64
``eigh`` on the CPU, ``symeig`` on a CPU tensor held to
``torch.linalg.eigh`` bit for bit, and the CUDA kernel (``csrc/syevj.cu``)
held to the plain version and to float64 ``torch.linalg.eigh`` on a card,
with its launch counts on the CMF's paths.

The card tests skip without a card. This file imports no JAX, so it runs
where the card is, without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_eigh.py
"""

import functools

import numpy as np
import pytest
import torch

from srcfinder_torch.cmf import matched_filter as mfmod
from srcfinder_torch.ops import eigh

DTYPES = {"float32": torch.float32, "float64": torch.float64}
KINDS = ("cmf", "graded", "identity", "block", "nonfinite")


def _cmf_matrix(rng, B, lines=400):
    """The CMF's whitened covariance of a seeded radiance-like column: the
    correlation matrix of |N(4, 0.5^2)| + 0.5 spectra with a common
    brightness factor per line (a spread spectrum, as real columns have)."""
    x = np.abs(rng.normal(4.0, 0.5, (lines, B))) + 0.5
    x *= 1.0 + 0.3 * rng.random((lines, 1))
    S = np.atleast_2d(np.cov(x, rowvar=False))
    d = np.sqrt(np.diag(S))
    return S / np.outer(d, d)


def _orthogonal(rng, B):
    q, r = np.linalg.qr(rng.normal(size=(B, B)))
    return q * np.sign(np.diag(r))


def _matrix(kind, B, seed):
    """One B x B symmetric float64 matrix of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "cmf":
        return _cmf_matrix(rng, B)
    if kind == "graded":
        # D R D with D from 1 down to 1e-3: condition ~1e-6 and rows of
        # very different size, where the relative threshold matters
        d = np.logspace(0.0, -3.0, B)
        return _cmf_matrix(rng, B) * np.outer(d, d)
    if kind == "identity":
        return np.eye(B)
    if kind == "block":
        # eigenvalues 1, 2 and 3 with multiplicity ~B/3 each, rotated
        lam = np.repeat([1.0, 2.0, 3.0], -(-B // 3))[:B]
        Q = _orthogonal(rng, B)
        return (Q * lam) @ Q.T
    if kind == "nonfinite":
        M = _cmf_matrix(rng, B)
        M[B // 2, B // 3] = np.nan
        M[B - 1, 0] = np.inf
        return M
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def _ref_solve(dname, B):
    """syevj_ref of two matrices of every kind (one call a dtype and size,
    shared by the kinds' cases): (M float64, lam, V, sweeps) by kind."""
    Ms = {k: np.stack([_matrix(k, B, 100 * B + i) for i in range(2)]) for k in KINDS}
    lam, V, sweeps = eigh.syevj_ref(torch.from_numpy(np.concatenate(list(Ms.values())))
                                    .to(DTYPES[dname]))
    out = {}
    for i, k in enumerate(KINDS):
        sl = slice(2 * i, 2 * i + 2)
        out[k] = (Ms[k], lam[sl].double().numpy(), V[sl].double().numpy(), sweeps[sl].numpy())
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [7, 72, 82])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_plain_jacobi_against_numpy(dname, B, kind):
    """Eigenvalues within B eps ||M|| of numpy's float64 ones, ascending;
    ||V diag(lam) V^T - M|| within B eps ||M|| and ||V^T V - I|| within
    B eps (the rotations' rounding, a few per element a sweep); a sweep
    count under the cap; NaN eigenvalues, an identity V and 0 sweeps for a
    non-finite matrix."""
    M, lam, V, sweeps = _ref_solve(dname, B)[kind]
    eps = torch.finfo(DTYPES[dname]).eps
    if kind == "nonfinite":
        assert np.isnan(lam).all()
        np.testing.assert_array_equal(V, np.broadcast_to(np.eye(B), V.shape))
        np.testing.assert_array_equal(sweeps, 0)
        return
    Mw = M.astype(np.float32 if dname == "float32" else np.float64).astype(np.float64)
    for Mi, li, Vi, si in zip(Mw, lam, V, sweeps):
        norm = np.linalg.norm(Mi, 2)
        assert np.abs(li - np.linalg.eigvalsh(Mi)).max() <= B * eps * norm
        assert (np.diff(li) >= 0).all()
        assert np.abs((Vi * li) @ Vi.T - Mi).max() <= B * eps * norm
        assert np.abs(Vi.T @ Vi - np.eye(B)).max() <= B * eps
        assert 1 <= si < eigh.MAX_SWEEPS[DTYPES[dname]]
    if kind == "identity":
        np.testing.assert_array_equal(sweeps, 1)     # nothing to rotate
        np.testing.assert_array_equal(V, np.broadcast_to(np.eye(B), V.shape))


@pytest.mark.parametrize("N", [2, 4, 8, 72, 82])
def test_round_robin_pairs_meet_once_a_sweep(N):
    """Every step's pairs are disjoint and cover 0..N-1; every pair of
    indices meets in exactly one step of a sweep."""
    p, q = eigh._pairs(N)
    assert p.shape == q.shape == (N - 1, N // 2)
    for k in range(N - 1):
        assert sorted(p[k].tolist() + q[k].tolist()) == list(range(N))
    met = {tuple(sorted(pq)) for pq in zip(p.flatten().tolist(), q.flatten().tolist())}
    assert len(met) == N * (N - 1) // 2


def test_plain_jacobi_reads_the_lower_triangle():
    """As torch.linalg.eigh: the upper triangle is not read."""
    M = torch.from_numpy(_matrix("cmf", 9, 3))
    junk = M + torch.triu(torch.full_like(M, 7.0), 1)
    for a, b in zip(eigh.syevj_ref(M[None]), eigh.syevj_ref(junk[None])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_symeig_on_the_cpu_is_torch_eigh(dname):
    """symeig on a CPU tensor gives torch.linalg.eigh's answer bit for bit,
    and NaN eigenvalues for the non-finite matrices of the batch, the
    others' answers unchanged."""
    dt = DTYPES[dname]
    M = torch.from_numpy(np.stack([_matrix(k, 72, i) for i, k in
                                   enumerate(("cmf", "graded", "block"))])).to(dt)
    for got, want in zip(eigh.symeig(M), torch.linalg.eigh(M)):
        assert torch.equal(got, want)
    bad = torch.cat([M, torch.from_numpy(_matrix("nonfinite", 72, 9)).to(dt)[None]])
    lam, V = eigh.symeig(bad)
    assert torch.isnan(lam[3]).all()
    assert torch.equal(V[3], torch.eye(72, dtype=dt))
    for got, want in zip((lam[:3], V[:3]), torch.linalg.eigh(M)):
        assert torch.equal(got, want)
    # leading batch dimensions pass through
    lam4, V4 = eigh.symeig(M.reshape(3, 1, 72, 72))
    assert lam4.shape == (3, 1, 72) and torch.equal(lam4[:, 0], lam[:3])


def test_kernel_limits_follow_shared_memory():
    """A and V of one matrix in one block's 232,448 bytes: B <= 168 in
    float32 (the CMF's 72 and 82 bands), <= 118 in float64; reflectance's
    415 bands go to the library."""
    for dt, top in ((torch.float32, 168), (torch.float64, 118)):
        assert eigh.fits(top, dt) and eigh.fits(top - 1, dt)
        assert not eigh.fits(top + 1, dt) and not eigh.fits(top + 2, dt)
        assert eigh.smem_bytes(top, dt) <= eigh.SMEM_MAX < eigh.smem_bytes(top + 2, dt)
    assert eigh.fits(72, torch.float32) and eigh.fits(82, torch.float64)
    assert not eigh.fits(415, torch.float32) and not eigh.fits(72, torch.bfloat16)
    assert eigh.smem_bytes(72, torch.float32) == 4 * (2 * 72 * 73 + 72) + 8 * 72
    assert eigh.smem_bytes(7, torch.float64) == eigh.smem_bytes(8, torch.float64)


@pytest.mark.parametrize("args,err", [((torch.zeros(2, 3, 4),), ValueError),
                                      ((torch.zeros(3),), ValueError)])
def test_symeig_rejects(args, err):
    with pytest.raises(err):
        eigh.symeig(*args)


def test_syevj_needs_a_card_tensor():
    with pytest.raises(ValueError):
        eigh.syevj(torch.eye(4)[None])


# ---- the kernel on a card ------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the eigensolve kernel has no CPU version")
    eigh.reset()
    return torch.device("cuda")


def _chunk(card, dtype, C=256, B=72, seed=0):
    """(C, B, B) CMF correlation matrices of seeded radiance-like columns
    on the card."""
    return torch.from_numpy(np.stack([_matrix("cmf", B, seed + i) for i in range(C)])
                            ).to(card, dtype)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_kernel_against_plain_and_float64_eigh(card, dname):
    """At one column chunk's shape (256, 72, 72): eigenvalues within B eps
    ||M|| of float64 torch.linalg.eigh's and of the plain version's,
    ascending; V diag(lam) V^T within B eps ||M|| of M and V^T V within B
    eps of I; the kernel's sweep counts within one of the plain version's
    and under the cap; two launches bit-identical; one launch each."""
    dt = DTYPES[dname]
    eps = torch.finfo(dt).eps
    M = _chunk(card, dt)
    lam, V, sweeps = eigh.syevj(M)
    assert eigh.launches() == 1
    lr, Vr, sr = eigh.syevj_ref(M)
    M64 = M.double()
    norm = torch.linalg.matrix_norm(M64, ord=2)[:, None]
    B = M.shape[-1]
    l64 = torch.linalg.eigvalsh(M64)
    assert ((lam.double() - l64).abs() <= B * eps * norm).all()
    assert ((lam.double() - lr.double()).abs() <= B * eps * norm).all()
    assert (lam[:, 1:] >= lam[:, :-1]).all()
    rec = V.double() @ torch.diag_embed(lam.double()) @ V.double().mT - M64
    assert (rec.abs().amax(dim=2) <= B * eps * norm).all()
    eye = torch.eye(B, dtype=torch.float64, device=card)
    assert (V.double().mT @ V.double() - eye).abs().max() <= B * eps
    assert ((sweeps - sr).abs() <= 1).all()
    assert (sweeps >= 1).all() and (sweeps < eigh.MAX_SWEEPS[dt]).all()
    for a, b in zip(eigh.syevj(M), (lam, V, sweeps)):
        assert torch.equal(a, b)
    assert eigh.launches() == 2


@pytest.mark.parametrize("B,dname", [(1, "float32"), (7, "float32"), (71, "float32"),
                                     (82, "float32"), (168, "float32"), (7, "float64"),
                                     (82, "float64"), (118, "float64")])
def test_kernel_odd_and_largest_sizes(card, B, dname):
    """Odd sizes (a dummy index), the CO2 window and the largest size of
    each precision; a non-finite matrix of the batch gives NaN
    eigenvalues, an identity V and 0 sweeps, the others are solved."""
    dt = DTYPES[dname]
    eps = torch.finfo(dt).eps
    M = torch.from_numpy(np.stack([_matrix("graded" if i % 2 else "cmf", B, 7 * B + i)
                                   for i in range(8)])).to(card, dt)
    M[3, B - 1, 0] = float("nan")
    lam, V, sweeps = eigh.syevj(M)
    assert torch.isnan(lam[3]).all() and sweeps[3].item() == 0
    assert torch.equal(V[3], torch.eye(B, dtype=dt, device=card))
    good = torch.arange(8, device=card) != 3
    M64 = M[good].double()
    norm = torch.linalg.matrix_norm(M64, ord=2)[:, None]
    assert ((lam[good].double() - torch.linalg.eigvalsh(M64)).abs() <= B * eps * norm).all()
    rec = V[good].double() @ torch.diag_embed(lam[good].double()) @ V[good].double().mT - M64
    assert (rec.abs().amax(dim=2) <= B * eps * norm).all()
    assert (sweeps[good] >= 1).all() and (sweeps < eigh.MAX_SWEEPS[dt]).all()


def test_large_bands_take_the_library_and_are_counted(card):
    """A B over the shared-memory limit (f32 170, f64 120) goes to
    torch.linalg.eigh, counted in library_calls(), not in launches()."""
    for dt, B in ((torch.float32, 170), (torch.float64, 120)):
        M = torch.from_numpy(np.stack([_matrix("cmf", B, 1)])).to(card, dt)
        lam, V = eigh.symeig(M)
        want = torch.linalg.eigh(M)
        assert torch.equal(lam, want[0]) and torch.equal(V, want[1])
    assert eigh.library_calls() == 2 and eigh.launches() == 0


def _cmf_inputs(card, L=300, C=8, B=72, seed=11):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(L, C, B, generator=gen) * 0.5 + 4.0).abs() + 0.5
    x[:, :, 40:] *= 1.0 + 0.5 * (torch.arange(L) < L // 2).float()[:, None, None]
    x[::37, :, 3] = -1.0                       # invalid rows
    x = x.to(card)
    m = mfmod.valid_mask(x).to(x.dtype)
    alphas = torch.as_tensor(mfmod.default_alphas(np.float32), device=card)
    abscf = torch.full((B,), -0.05, device=card)
    return x, m, abscf, alphas


def test_a_cuda_tensor_never_reaches_the_plain_version(card, monkeypatch):
    """On the card the CMF's eigensolves are the kernel's: neither the
    plain version nor the library route runs."""
    def plain(*a, **k):
        raise AssertionError("a CPU route ran on a CUDA tensor")
    monkeypatch.setattr(eigh, "syevj_ref", plain)
    monkeypatch.setattr(eigh, "_guarded_eigh", plain)
    x, m, abscf, alphas = _cmf_inputs(card)
    res = mfmod.matched_filter_columns(x, m, abscf, alphas)
    assert torch.isfinite(res.mf).all()
    assert eigh.launches() == 1 and eigh.library_calls() == 0


@pytest.mark.parametrize("bgmodes", [1, 3])
def test_launches_a_chunk(card, bgmodes):
    """One launch a chunk in matched_filter_columns; 1 + K (the PCA and
    one a mode) in the multimodal path; none through the library."""
    x, m, abscf, alphas = _cmf_inputs(card)
    if bgmodes == 1:
        mfmod.matched_filter_columns(x, m, abscf, alphas)
    else:
        mfmod.matched_filter_columns_multimodal(x, m, abscf, alphas, bgmodes=bgmodes)
    assert eigh.launches() == (1 if bgmodes == 1 else 1 + bgmodes)
    assert eigh.library_calls() == 0
