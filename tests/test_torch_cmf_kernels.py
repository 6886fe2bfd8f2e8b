"""The CMF kernels' decomposition, held on the CPU.

The CUDA kernels of masked moments (K1, csrc/moments.cu) and of the LOOCV
sweep (K2, csrc/loo.cu) split each column's lines over blocks, as
``moments.plan`` and ``loo.plan`` say, and add the per-split partials in
split order. This file checks the plans (coverage, grid size, shared
memory, alpha padding) and replays each kernel's decomposition in plain
PyTorch from its plan, held to the plain version (f64 within 1e-12 of the
largest output) and to the JAX package (the tolerances of
tests/test_torch_cmf.py). The kernels themselves are held to their plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcfinder_tpu.cmf import matched_filter as jmf
from srcfinder_torch.cmf import matched_filter as tmf
from srcfinder_torch.ops import loo, moments
from tests.test_cmf_parity import synth_radiance

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _relerr(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-300)).item()


def _ranges(splits, lines, L):
    return [(s * lines, min(L, (s + 1) * lines)) for s in range(splits)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [1, 37, 2801])
@pytest.mark.parametrize("C", [1, 8, 86, 256])
def test_plans_split_lines_exactly_once(L, C, dtype):
    for p in (moments.plan(L, C, 72, dtype), loo.plan(L, C, 72, 201, dtype)):
        cover = np.zeros(L, int)
        for l0, l1 in _ranges(p.splits, p.lines, L):
            assert l0 < l1, p
            cover[l0:l1] += 1
        assert (cover == 1).all(), p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [8, 86, 256])
def test_plans_fill_the_card(C, dtype):
    """At least two blocks per SM of an H100 (264) on a full-scene column
    chunk and on the few columns of the cond-gated f64 recompute."""
    pm = moments.plan(2801, C, 72, dtype)
    pl = loo.plan(2801, C, 72, 201, dtype)
    assert pm.splits * C * pm.tgroups >= 264
    assert pl.splits * C * pl.a_groups >= 264


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [10, 72, 82, 415])
def test_plans_fit_shared_memory(B, dtype):
    size = dtype.itemsize
    pm = moments.plan(2801, 256, B, dtype)
    pl = loo.plan(2801, 256, B, 201, dtype)
    assert pm.smem <= 232_448 and pl.smem <= 232_448
    # K1: the staged tiles and the group sums share one region
    b8 = -(-B // 8) * 8
    assert pm.kstride == b8 + (16 // size) * (b8 // (128 // size))   # 16 B gap per 128 B
    assert pm.smem == (b8 + moments.STAGES * pm.tl) * size + max(
        moments.STAGES * pm.tl * pm.kstride * size, moments.GROUPS * pm.tpb * 64 * size)
    assert pm.threads == pm.tpb * moments.GROUPS <= 180
    # K2: the band chunks cover B; ig is staged whole
    assert pl.kc % 4 == 0                          # whole 16-byte f32 copies, DMMA k = 4
    assert pl.nch * pl.kc >= B > (pl.nch - 1) * pl.kc
    assert pl.nch * pl.kc * pl.istride * size < pl.smem
    if B == 72:
        assert (pl.nch, pl.kc, pl.a_groups) == (1, 72, 1)      # B taken whole
        if dtype == torch.float32:
            assert 2 * (pl.smem + 1024) <= 233_472             # two blocks per SM


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("A", [1, 7, 201, 300])
def test_loo_plan_pads_alphas_to_the_tile(A, dtype):
    p = loo.plan(2801, 256, 72, A, dtype)
    assert p.a_grp % loo.WARP_A[dtype] == 0 and p.a_grp <= loo.MAX_A[dtype]
    assert p.a_groups * p.a_grp >= A > (p.a_groups - 1) * p.a_grp
    assert p.threads == loo.THREADS[dtype] >= 32 * p.a_grp // loo.WARP_A[dtype]
    if A == 201:    # one block sweeps all alphas: 224 (7 warps) f32, 208 (13) f64
        assert (p.a_grp, p.a_groups) == ({torch.float32: 224, torch.float64: 208}[dtype], 1)
    assert p.partial == (p.splits, 256, A)
    # the shared rows of Z^2 are 4 (mod 16) elements apart: f64 DMMA
    # fragment reads of a half-warp hit 16 distinct bank pairs, and f32
    # reads of 8 consecutive rows 8 distinct bank pairs
    assert p.kstride % 16 in (4, 12)
    if dtype == torch.float64:
        assert p.istride % 16 in (4, 12)


def _tile_entries(nb8, B, t):
    """Packed-triangle entries (i <= j < B) of the t-th 8 x 8 tile on or
    above the diagonal, in the kernel's tile order."""
    I = 0
    while t >= nb8 - I:
        t -= nb8 - I
        I += 1
    J = I + t
    return [(i, j) for i in range(8 * I, 8 * I + 8) for j in range(8 * J, 8 * J + 8)
            if i <= j < B]


def moments_replay(x, m):
    """masked_moments as csrc/moments.cu decomposes it: per-split counts
    and sums added in split order, then per-split scatters of the centred
    values, each packed triangle written tile group by tile group, added
    in split order."""
    L, C, B = x.shape
    p = moments.plan(L, C, B, x.dtype)
    m = m.to(x.dtype)
    ranges = _ranges(p.splits, p.lines, L)
    pcnt = torch.stack([m[l0:l1].sum(dim=0) for l0, l1 in ranges])
    psum = torch.stack([torch.einsum("lc,lcb->cb", m[l0:l1], x[l0:l1]) for l0, l1 in ranges])
    n, s = pcnt[0].clone(), psum[0].clone()
    for k in range(1, p.splits):
        n, s = n + pcnt[k], s + psum[k]
    mu = s / torch.clamp(n, min=1.0)[:, None]
    nb8 = -(-B // 8)
    iu = torch.triu_indices(B, B)
    packed = {(i, j): k for k, (i, j) in enumerate(iu.T.tolist())}
    ptri = torch.full(p.ptri, float("nan"), dtype=x.dtype)
    for sp, (l0, l1) in enumerate(ranges):
        xc = (x[l0:l1] - mu[None]) * m[l0:l1, :, None]
        full = torch.einsum("lcb,lcd->cbd", xc, xc)
        for tg in range(p.tgroups):
            for t in range(tg * p.tpb, min((tg + 1) * p.tpb, nb8 * (nb8 + 1) // 2)):
                for i, j in _tile_entries(nb8, B, t):
                    assert torch.isnan(ptri[sp, 0, packed[i, j]])   # written once
                    ptri[sp, :, packed[i, j]] = full[:, i, j]
    assert not torch.isnan(ptri).any()                               # and all written
    tri = ptri[0].clone()
    for k in range(1, p.splits):
        tri = tri + ptri[k]
    S = torch.empty(C, B, B, dtype=x.dtype)
    S[:, iu[0], iu[1]] = tri
    S[:, iu[1], iu[0]] = tri
    return n, mu, S / torch.clamp(n - 1.0, min=1.0)[:, None, None]


def loo_replay(Z, inv_glam, beta, m):
    """loo_sweep as csrc/loo.cu decomposes it: per (split, alpha group)
    partial sums and flags over the split's lines, with the group padded
    to a_grp alphas (ig = beta = 0) and the padding dropped, added and
    ANDed in split order."""
    L, C, B = Z.shape
    A = inv_glam.shape[-1]
    p = loo.plan(L, C, B, A, Z.dtype)
    pss = torch.full(p.partial, float("nan"), dtype=Z.dtype)
    pok = torch.zeros(p.partial, dtype=torch.bool)
    for sp, (l0, l1) in enumerate(_ranges(p.splits, p.lines, L)):
        for g in range(p.a_groups):
            a0, a1 = g * p.a_grp, min(A, (g + 1) * p.a_grp)
            ig = torch.zeros(C, B, p.a_grp, dtype=Z.dtype)
            bt = torch.zeros(C, p.a_grp, dtype=Z.dtype)
            ig[:, :, :a1 - a0], bt[:, :a1 - a0] = inv_glam[:, :, a0:a1], beta[:, a0:a1]
            s, ok = loo.loo_sweep_ref(Z[l0:l1], ig, bt, m[l0:l1])
            # the padded alphas see r = 0 and beta = 0: q = 1, no term
            assert (s[:, a1 - a0:] == 0).all() and ok[:, a1 - a0:].all()
            assert torch.isnan(pss[sp, :, a0:a1]).all()              # written once
            pss[sp, :, a0:a1], pok[sp, :, a0:a1] = s[:, :a1 - a0], ok[:, :a1 - a0]
    assert not torch.isnan(pss).any()                                # and all written
    ssum, q_ok = pss[0].clone(), pok[0].clone()
    for k in range(1, p.splits):
        ssum, q_ok = ssum + pss[k], q_ok & pok[k]
    return ssum, q_ok


def _moments_inputs(rng, L, C, B, dtype):
    """synth_radiance with a column of no valid line (n = 0) and one of a
    single valid line (n = 1): the max(n - 1, 1) branches."""
    x = synth_radiance(rng, L=L, C=C, B=B).astype(dtype)
    m = np.asarray(jmf.valid_mask(x)).astype(dtype)
    m[:, 0] = 0.0
    m[:, 1] = 0.0
    m[L // 2, 1] = 1.0
    x = np.where(m[:, :, None] > 0, x, 0.0).astype(dtype)
    return x, m


@pytest.mark.parametrize("L,C,B", [(150, 4, 12), (70, 4, 82)])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_moments_replay_matches_plain_and_jax(rng, L, C, B, dtype, rtol):
    x, m = _moments_inputs(rng, L, C, B, dtype)
    assert moments.plan(L, C, B, torch.float32).splits > 1
    got = moments_replay(_t(x), _t(m))
    ref = moments.masked_moments_ref(_t(x), _t(m))
    assert got[0][:2].tolist() == [0.0, 1.0]
    if dtype == np.float64:
        for g, r in zip(got, ref):
            assert _relerr(g, r) <= 1e-12
    with jax.enable_x64(dtype == np.float64):
        jref = [np.asarray(a) for a in jmf.masked_moments(x, m)]
    for g, r in zip(got, jref):
        assert g.dtype == _t(r).dtype
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=rtol * np.abs(r).max())


def _loo_inputs(rng, L, C, B):
    """The CMF's own sweep inputs on synth_radiance (f64), plus the parts
    of _loo_nll around the sweep, with a column of no valid line and a
    line whose q <= 0 for some alphas on a valid line of column 2."""
    x, m = _moments_inputs(rng, L, C, B, np.float64)
    n, mu, S = [a.numpy() for a in moments.masked_moments_ref(_t(x), _t(m))]
    d = np.sqrt(np.maximum(np.diagonal(S, axis1=1, axis2=2), 1e-30))
    lam, V = np.linalg.eigh(S / (d[:, :, None] * d[:, None, :]))
    Z = np.einsum("lcb,cbk->lck", (x - mu[None]) * m[:, :, None], V / d[:, :, None])
    valid2 = np.nonzero(m[:, 2])[0]
    Z[valid2[3], 2] *= 40.0                    # leverage > 1 on a valid line
    return x, m, lam, Z, np.log(d), n


def _sweep_args(lam, Z, n, m, al):
    """inv_glam and beta exactly as _loo_nll forms them."""
    beta = (1.0 - al)[None, :] / np.maximum(n - 1.0, 1.0)[:, None]
    glam = (n[:, None] * beta)[:, None, :] * lam[:, :, None] + al[None, None, :]
    inv_glam = 1.0 / np.where(glam > 0, glam, 1.0)
    return _t(Z), _t(inv_glam), _t(beta), _t(m)


@pytest.mark.parametrize("L,C,B,A", [(150, 4, 12, 201), (70, 4, 415, 201), (40, 4, 10, 7)])
def test_loo_replay_matches_plain(rng, L, C, B, A):
    x, m, lam, Z, logdiag, n = _loo_inputs(rng, L, C, B)
    al = jmf.default_alphas()[::max(1, 201 // A)][:A]
    args = _sweep_args(lam, Z, n, m, al)
    got, ref = loo_replay(*args), loo.loo_sweep_ref(*args)
    assert got[0].shape == (C, A)                 # alpha padding dropped
    assert _relerr(got[0], ref[0]) <= 1e-12
    assert torch.equal(got[1], ref[1])
    assert not ref[1][2].all() and ref[1][[0, 1, 3]].all()


def test_loo_replay_matches_jax_nll(rng, monkeypatch):
    """_loo_nll through the replayed decomposition == the JAX _loo_nll
    (f64), on inputs with q <= 0 on a valid line and an empty column."""
    L, C, B = 150, 4, 12
    x, m, lam, Z, logdiag, n = _loo_inputs(rng, L, C, B)
    assert loo.plan(L, C, B, 201, torch.float64).splits > 1
    al = jmf.default_alphas()
    monkeypatch.setattr(tmf, "loo_sweep", loo_replay)
    got = tmf._loo_nll(_t(lam), _t(Z), _t(logdiag), _t(n), _t(m), _t(al), B).numpy()
    with jax.enable_x64(True):
        ref = np.asarray(jmf._loo_nll(jnp.asarray(lam), jnp.asarray(Z),
                                      jnp.asarray(logdiag), jnp.asarray(n),
                                      jnp.asarray(m), jnp.asarray(al), B))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any() and not fin[2].all()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)
