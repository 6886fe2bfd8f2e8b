#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device and the CUDA toolkit (nvcc). Phases:

1. Device and build: print the card's name and power limit, build the
   port's CUDA kernels from srcfinder_torch/ops/csrc (one nvcc for each
   source, all started together), print each kernel's registers and
   spills (ptxas -v) and count the tensor-core instructions (HMMA,
   HGMMA, DMMA) in the SASS of each kernel of the built libraries
   (cuobjdump); the trunk library must have some, P2's bf16 front kernel
   (front_kernel<bf16>) HGMMA, and the f64 LOOCV kernel
   (loo_kernel<double>) DMMA.
2. The bf16 convolutions of trunk_s23 and trunk_s45, one by one: every
   distinct conv the two segments launch (srcfinder_torch.ops.trunk_fuse.
   conv_plan) at the CLI's configuration (4096 windows of 256 x 256, in
   the sub-batches the segments run), through the single-conv entry with
   the segment's channel offsets, pixel strides and split, against the
   plain conv in bf16 (TRUNK_TOL), with channels outside the written ones
   left as they were. Prints ms, achieved TFLOP/s and the tile the
   dispatch picked for each (it must be the tensor-core kernel's). Then
   trunk_s45 on 3 windows, whose last blocks end in a ragged row tile, and
   P2's layers one by one (front kernel, conv3, pool2: device ms of each
   in a profiled call at 512 windows in f32 and bf16 and at 4096 in bf16,
   on seeded windows and weights).
3. Kernels against their plain PyTorch versions on the card, at the
   shapes of one full-scene CMF column chunk (2801 lines x 256 columns x
   72 active bands, 201 alphas), in float32 and float64, and on 8 of its
   columns in float64 (the cond-gated f64 recompute's shape,
   "float64_c8"), on inputs made by the CMF's own steps from seeded
   radiance with invalid rows. Each kernel must also give bit-identical
   outputs on two launches, and the nll built from the LOOCV kernel's
   sums must pick the plain version's alpha on every column (or a
   minimum within TOL of it). Then both at small shapes off that path
   (ODD_SHAPES: 82 and 415 bands, unaligned rows, one line) in both
   dtypes. Prints the eigensolve's time and one {"kernels": [...]} line.
4. The main path at real size: a seeded synthetic AVIRIS-NG-shaped
   flightline (2801 lines x 598 samples x 425 bands, f32 BIL, ~2.85 GB,
   written in line blocks) with a methane plume and a CH4 library,
   GoogLeNet weights from a seeded torch.Generator in the JAX package's
   .npz layout, then srcfinder_torch.flow.pipeline_cli.run_flightline with
   IME. Kernel launch counters are zeroed just before and read just
   after; every kernel must have launched. Checks the outputs (plume
   ppm*m above background, saliency in [0, 1] with nodata stamped, plume
   list and IME CSV written) and prints stage seconds and peak device
   memory.
4b. The multimodal CMF ("multimodal" line): the same recipe with two
   background modes (the first half of the lines raised by MODE_OFFSET),
   through run_flightline(bgmodes=2) with IME, its K1/K2 launches counted
   from zero (with eigh calls and f64-gated columns, per chunk); then
   srcfinder_torch.cmf.cli -k 3 -r -f -m in a process of its own, and the
   bgmodes=2 CMF in float64 on the card with its labels. The labels must
   find the two modes (agreement > LABEL_AGREEMENT up to a swap in every
   column), the f32 map lie within MM_F32_TOL of the f64 map's maximum and
   the plume's z exceed 10; K1 and K2 at the run's mode-1 masks of its
   padded last chunk (modes empty in the padded columns) with beta from
   the full column's count, in f32 and f64, against their plain versions
   (TOL, the argmin check, repeats bit-identical). Prints seconds per
   stage and peak device memory; the scene is deleted after.
5. The exact dense CNN's trunk kernels (fused_stage12, trunk_s23,
   trunk_s3, trunk_s45) against their plain versions, on windows of 256 x
   256 gathered from a 16-line strip cut through the plume of the scene's
   CMF ppm*m band and preprocessed: 512 windows in float32 and bfloat16,
   and all four at the CLI's own configuration (bfloat16, 4096 windows,
   where trunk_s23 and trunk_s3 run as sub-batches). The segment inputs
   are the plain route's own intermediates. GoogLeNet weights are
   "trained-like" (conv and fc std sqrt(1 / fan_in), BatchNorm perturbed;
   torch.Generator seed 256), so activations stay O(1). Prints errors,
   kernel / plain / cuDNN-model times (CUDA events) and each kernel's
   bound. fused_stage12's gather form, reading the windows from the padded
   strip, must equal the contiguous form bit for bit, and two launches of
   each kernel must agree bit for bit; P2 on 3 windows at D = 40 (ragged
   front tiles), 64 and 256 in both dtypes within TRUNK_TOL.
6. The exact path on that strip (16 lines x 598 samples = 9,568 windows;
   only the scene's line count is cut, the window, the model's widths and
   the batches are real): srcfinder_torch.detect.cnn_cli at its defaults
   (bfloat16, batch 4096, the default trunk route; the main path), held
   within CLI_TOL of the plain route in bfloat16 at batch 4096, and the
   other of the "stage12" and "segments" routes in the same
   configuration, held the same way; then cnn_saliency_image in float32
   with each trunk route at batch 512 and with "segments" at batch 4096
   (kernel routes must agree with "plain" within 1e-5 in probability),
   then the fast method. Each run zeroes the launch counters just before
   and reads them just after, and must have launched exactly its route's
   trunk kernels. Prints seconds, windows/s, peak device memory, launches
   and a full-scene projection for each run. Profiles the default route
   in f32 and both kernel routes in the CLI's configuration (device-busy
   ms, idle share, peak memory; the segments profile must name the
   tensor-core conv kernel, the stage12 profile the front kernel and no
   cuDNN convolution), with branch 4's device time in each; the default
   route must be the one with less device-busy time.

7. The FCN's other paths on the scene's CMF ppm*m band (2801 x 598),
   with the trained-like weights of phase 5 unless said otherwise (ms and
   peak device memory of each, and its difference beside its bound):
   the unblocked phase pass, in f32 and bf16 (bf16 within BF16_TOL); on
   the band's first 2784 lines (the 32-line grid) the halo-blocked path
   at block 928 against the unblocked pass (PATH_TOL); two copies of the
   band through fcn_phase_saliency_batch against the single scene
   (PATH_TOL); the scan layout against the wide one (PATH_TOL); the
   dilated pass against the phase pass with the trained-like weights:
   within PATH_TOL on the interior (pixels at least DILATED_REACH from
   every image edge, out of reach of every canvas edge), the whole map's
   largest gap and its row and column reported with the largest gap past
   each margin from the edges; the dilated pass in bf16, and in f32 at
   the largest scene its canvas ceiling admits (3,647 lines), whose peak
   must stay under the card's memory and whose seconds per canvas pixel
   must stay within DILATED_SLOWDOWN of the 2801-line pass's (past the
   ceiling the card runs short of convolution workspace and the pass
   slows ~13x); the dilated pass against the phase
   pass within BF16_TOL over the whole map with the weights the JAX
   package's bound holds for (init-time convs, BatchNorm perturbed).
8. A real-length flightline: a seeded 12,000 x 598 x 425 f32 BIL radiance
   (12.2 GB; the 2801-line radiance is deleted first) with a methane
   plume, nodata pixels, and a saturated, a specular, a cloud and a dark
   patch, through run_flightline with the masks and IME at the defaults
   (prob_thr 0 as in phase 4): the fused cmf+masks single read, then the
   FCN through the halo-blocked path (3 windows of 5,824 lines). Checks
   the plume's z, the route and windows, that each mask band is
   non-empty and equal to masks_for_flightline on the CPU over the same
   file, that K1/K2 launched, and K1/K2 at this chunk shape (12,000 x 256
   x 72, f32) against their plain versions (TOL, repeats bit-identical);
   prints stage seconds, the fused read+masks phase by part (disk reads
   and slab taps in the reader thread; pixel tests, host growth and block
   waits in the main one), peak device memory, the windows' peaks, and
   the unblocked phase pass's peak at the pixel ceiling (8,352 lines).
   Then times the fused read's band runs of the file through the old
   memmap fancy index, DirectFile with O_DIRECT, DirectFile with
   SRCFINDER_DIRECT_IO=0 (the port's mapped copies) and one pread per run
   per line (the JAX package's buffered path; it and the memmap index are
   kept here only), in turns per 500-line block, byte-equal, with the
   mode each file ended in ("readers").

Any failed phase exits non-zero without the result line. The last line
of standard output is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cmf-times TREE
    python3 chip_smoke.py --trunk-times TREE

only time the CMF kernels (on phase 3's inputs; see cmf_times) or P2,
fused_stage12 (on seeded windows; see trunk_times), of TREE's
srcfinder_torch, for a same-call A/B of two commits.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# one full-scene CMF column chunk (AVIRIS-NG lines, col_chunk, CH4 window)
L, C, B, A = 2801, 256, 72, 201
SCENE = (2801, 598, 425)          # lines, samples, bands
PLUME = (slice(1380, 1420), slice(290, 310))
# H100 SXM data sheet: f32 outside the tensor cores (TF32 is not full
# precision); f64 on the FP64 tensor cores (DMMA), which are full IEEE f64;
# bf16 on the tensor cores (dense)
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12                                # H100 SXM HBM3
TOL = {"float32": 1e-5, "float64": 1e-12}           # max |err| / max |ref|
# exact dense CNN: window side, windows per trunk-kernel comparison, strip
# lines, and the trunk kernels' ceilings (max |err| / max |ref|): f32 allows
# for up to 14 stacked convolutions summed in another order (measured
# 1.0e-6 on the H100), bf16 for one-ulp flips at each rounding point
# (measured 8.3e-3)
WIN, STRIP_LINES = 256, 16
CLI_BATCH = 4096                   # cnn_cli's default --batch
TRUNK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TRUNK_KERNELS = ("fused_stage12", "trunk_s23", "trunk_s3", "trunk_s45")
# (dtype, windows) of the trunk-kernel comparisons: 512 windows in both
# dtypes, and the CLI's own configuration (bf16, batch 4096), where
# trunk_s23 runs as three sub-batches of its scratch budget and trunk_s3
# as two
TRUNK_CONFIGS = (("float32", 512), ("bfloat16", 512), ("bfloat16", CLI_BATCH))
# the trunk kernels each route launches
ROUTE_KERNELS = {"segments": ("trunk_s23", "trunk_s45"),
                 "stage12": ("fused_stage12", "trunk_s3", "trunk_s45"), "plain": ()}
# P2's side of each 3-window check: 40 leaves ragged 8 x 8 front tiles
STAGE12_SMALL = (40, 64, 256)


def kernel_run(kernel, default):
    """The run of the exact-CNN phase whose launches ``kernel`` reports:
    the CLI's (the default route at bf16, batch 4096) where that route
    launches it, else the other kernel route's run in the same
    configuration."""
    route = default if kernel in ROUTE_KERNELS[default] else next(
        r for r in ("stage12", "segments") if kernel in ROUTE_KERNELS[r])
    return f"{'cli_' if route == default else ''}bf16_{route}_b{CLI_BATCH}"
ROUTE_TOL = 1e-5                   # kernel route vs plain route, probability
# the CLI (bf16 kernels) vs the plain route in bf16 at the same batch, in
# probability: each is a bf16 rounding of the same f32 forward, and the
# CLI was measured 3.5e-3 from the f32 plain route, so two such roundings
# lie within 7e-3 of each other
CLI_TOL = 1e-2
# the FCN's paths (phase 7): an exact path against the one it must equal
# (cuDNN picks its algorithm per shape, so they differ by rounding, ~1e-6),
# and the bound the JAX package's tests set for bf16 and the dilated path
PATH_TOL, BF16_TOL = 1e-5, 2e-2
# the dilated and phase paths differ only within the trunk's reach of the
# canvas edges (half its 448-line halo: receptive radius plus the shift
# grid); margins at which phase 7 reports the largest gap
DILATED_REACH = 224
EDGE_MARGINS = (0, 16, 32, 64, 96, 128, 160, 192, 224, 256)
CARD_BYTES = 80e9
DILATED_SLOWDOWN = 3.0
# the two-mode scene (phase 4b): the first half of the lines raised in every
# band by the offset of tests/test_cmf_pipeline.py:259; k-means must find
# the two halves (label agreement up to a swap) in every column; the f32
# map's bound against the f64 one is that test's (of the f64 map's maximum)
MODE_OFFSET = 8.0
LABEL_AGREEMENT = 0.99
MM_F32_TOL = 5e-3
# the real-length flightline (phase 8): 12,000 lines, on the 32-line grid
LONG_SCENE = (12000, 598, 425)
LONG_PLUME = (slice(6000, 6040), slice(290, 310))


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_label(mangled):
    """``name<type, ints>`` of a mangled ``*_kernel`` template instance."""
    k = re.search(r"\d+([a-z_]+_kernel)I(\w+)", mangled)
    if not k:
        return mangled
    args = k.group(2)
    t = "bf16" if "bfloat16" in args else {"f": "float", "d": "double"}.get(args[0], args)
    return f"{k.group(1)}<{', '.join([t] + re.findall(r'L[ib](\d+)E', args))}>"


def ptxas_summary(log):
    """nvcc's ``ptxas -v`` output -> {kernel<type>: [resource lines]}:
    registers, shared memory and spills of each compiled kernel."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(" : ")[-1].strip())
    return out


def sass_mma_counts(lib):
    """{kernel: {"HMMA": n, "HGMMA": n, "DMMA": n}}: tensor-core
    instructions in the SASS of each kernel of a built library
    (``cuobjdump -sass``); DMMA is the FP64 tensor cores' product."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            out[name] = {"HMMA": 0, "HGMMA": 0, "DMMA": 0}
        elif name:
            for op in out[name]:
                out[name][op] += len(re.findall(rf"\b{op}\b", line))
    return out


def cuda_ms(fn, reps=10):
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_inputs(x, m, n_loo=None):
    """The CMF's own intermediates of ``x`` (invalid rows zeroed) under
    the mask ``m`` (the valid rows, or a background mode's): the
    correlation matrices, the kernels' inputs exactly as
    matched_filter_columns forms them, with beta from the count ``n_loo``
    (the mask's count if None), and the parts of _loo_nll around the
    sweep (``nll_parts``)."""
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod
    from srcfinder_torch.ops.moments import masked_moments_ref
    n, mu, S = masked_moments_ref(x, m)
    n_loo = n if n_loo is None else n_loo
    d = torch.sqrt(torch.clamp(torch.diagonal(S, dim1=1, dim2=2), min=1e-30))
    Rw = S / (d[:, :, None] * d[:, None, :])
    lam, V = torch.linalg.eigh(Rw)
    Zc = torch.bmm(((x - mu[None]) * m[:, :, None]).permute(1, 0, 2), V / d[:, :, None])
    alphas = torch.as_tensor(mfmod.default_alphas(), dtype=x.dtype, device=x.device)
    beta = (1.0 - alphas)[None, :] / torch.clamp(n_loo - 1.0, min=1.0)[:, None]
    glam = (n_loo[:, None] * beta)[:, None, :] * lam[:, :, None] + alphas[None, None, :]
    safe_glam = torch.where(glam > 0, glam, torch.ones_like(glam))
    inv_glam = 1.0 / safe_glam
    # nll = where(ok & q_ok, base + ssum * scale, inf), as _loo_nll forms it
    nll_parts = dict(
        base=0.5 * (x.shape[2] * math.log(2.0 * math.pi)
                    + 2.0 * torch.log(d).sum(dim=1)[:, None]
                    + torch.log(safe_glam).sum(dim=1)),
        scale=(1.0 / (2.0 * torch.clamp(n_loo, min=1.0)))[:, None],
        ok=torch.all(glam > 0, dim=1))
    return Rw, Zc.permute(1, 0, 2), inv_glam, beta, nll_parts


def chunk_inputs(dtype, gen, lines=L):
    """Radiance-like chunk of ``lines`` lines and the CMF's own
    intermediates for it (``sweep_inputs``)."""
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod
    x = (torch.randn(lines, C, B, generator=gen, device="cuda") * 0.5 + 4.0
         ).abs_().add_(0.5).to(dtype)
    x[::37, :, 3] = -1.0                       # invalid rows in every column
    m = mfmod.valid_mask(x).to(dtype)
    x = torch.where(m.bool()[:, :, None], x, torch.zeros((), dtype=dtype, device="cuda"))
    Rw, Z, inv_glam, beta, nll_parts = sweep_inputs(x, m)
    # real covariances keep q = 1 - beta*r > 0 (leverage < 1); a far
    # steeper beta on 8 columns drives q far below 0 there, for every alpha
    # but alpha = 1 (beta = 0), so the q_ok flag path runs too, with no q
    # near 0 where f32 rounding could flip it
    beta[-8:] *= 1e9
    return x, m, Rw, Z, inv_glam, beta, nll_parts


def c8_inputs(x, m, Z, inv_glam, beta, nll_parts):
    """The cond-gated f64 recompute's shape from a chunk's inputs: 8 of its
    columns (4 ordinary, 4 with the steep beta), laid out as the recompute
    forms them (x gathered, Z a permuted (C, L, B) product)."""
    import torch
    idx = torch.tensor([0, 1, 2, 3, C - 4, C - 3, C - 2, C - 1], device=x.device)
    Z8 = Z[:, idx].permute(1, 0, 2).contiguous().permute(1, 0, 2)
    return (x[:, idx].contiguous(), m[:, idx].contiguous(), Z8, inv_glam[idx].contiguous(),
            beta[idx].contiguous(), {k: v[idx] for k, v in nll_parts.items()})


def device_kernel_launches(fn):
    """Number of device kernels ``fn()`` launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Memcpy") and not e.name.startswith("Memset")
               and e.name not in _PROFILER_MARKERS)


def eigh_probe(Rw, gen):
    """torch.linalg.eigh over one chunk's 256 correlation matrices: time
    and device kernels per matrix, on the CMF's own matrices and on
    random correlation matrices with a spread spectrum, and the same
    256 matrices in a Python loop of single calls. cuSOLVER's Jacobi
    iterates until it converges, so its work depends on the spectrum."""
    import torch
    Cn, Bn, _ = Rw.shape
    A = torch.randn(Cn, Bn, Bn, generator=gen, device="cuda", dtype=Rw.dtype)
    S = A @ A.transpose(1, 2) + 1e-2 * torch.eye(Bn, device="cuda", dtype=Rw.dtype)
    dd = torch.sqrt(torch.diagonal(S, dim1=1, dim2=2))
    Rr = S / (dd[:, :, None] * dd[:, None, :])
    out = {}
    for tag, M in (("cmf", Rw), ("random", Rr)):
        lam = torch.linalg.eigvalsh(M.double())
        out[tag] = dict(ms=cuda_ms(lambda: torch.linalg.eigh(M), reps=3),
                        kernels_per_matrix=device_kernel_launches(
                            lambda: torch.linalg.eigh(M)) / Cn,
                        median_cond=(lam[:, 0] / lam[:, -1]).median().item())
    out["cmf_loop_of_single_calls_ms"] = cuda_ms(
        lambda: [torch.linalg.eigh(Rw[i]) for i in range(Cn)], reps=1)
    return out


def bit_identical(fn):
    """Two launches of ``fn()`` on one input give bit-identical outputs."""
    import torch
    a, b = fn(), fn()
    return all(torch.equal(u, v) for u, v in zip(a, b))


def loo_argmin_check(got, ref, parts, tol):
    """The alpha that _loo_nll's argmin picks from the kernel's ssum and
    from the plain version's: the same index on every column, or minima
    within ``tol`` of each other (relative). Returns the columns that
    picked another index; fails beyond the tolerance."""
    import torch

    def nll(ssum, q_ok):
        v = parts["base"] + ssum * parts["scale"]
        return torch.where(parts["ok"] & q_ok, v, torch.full_like(v, math.inf))
    nk, nr = nll(*got), nll(*ref)
    ik, ir = nk.argmin(dim=1), nr.argmin(dim=1)
    mk, mr = nk.min(dim=1).values, nr.min(dim=1).values
    if not torch.isfinite(mr).all():
        fail("loo_sweep: a column of the plain nll has no finite alpha")
    diff = (ik != ir).nonzero().flatten().tolist()
    for c in diff:
        rel = abs(mk[c].item() - mr[c].item()) / abs(mr[c].item())
        if not rel <= tol:
            fail(f"loo_sweep: column {c} picks alpha {ik[c].item()} against the plain "
                 f"version's {ir[c].item()}, minima {rel:.3g} apart > {tol:g}")
    return diff


def cmf_kernel_checks(name, x, m, Z, inv_glam, beta, parts):
    """K1 and K2 against their plain versions on one set of inputs:
    errors, bit-identical repeats, q_ok, the alpha argmin, times, bound."""
    import torch
    from srcfinder_torch.ops import loo, moments
    Lx, Cx, Bx = x.shape
    Ax = inv_glam.shape[-1]
    dname = "float64" if x.dtype == torch.float64 else "float32"
    tol = TOL[dname]
    s = x.element_size()

    # K1 masked moments
    got = moments.masked_moments(x, m)
    torch.cuda.synchronize()
    ref = moments.masked_moments_ref(x, m)
    xc = (x - ref[1][None]) * m[:, :, None]
    k1 = dict(
        max_abs_err=max((g - r).abs().max().item() for g, r in zip(got, ref)),
        max_rel_err=max(((g - r).abs().max() / r.abs().max().clamp(min=1e-300)).item()
                        for g, r in zip(got, ref)),
        bit_identical=bit_identical(lambda: moments.masked_moments(x, m)),
        ms=cuda_ms(lambda: moments.masked_moments(x, m)),
        plain_ms=cuda_ms(lambda: moments.masked_moments_ref(x, m), reps=3),
        library_ms=cuda_ms(lambda: torch.einsum("lcb,lcd->cbd", xc, xc), reps=3),
        library_call="einsum lcb,lcd->cbd: the scatter of an already centred, "
                     "masked cube (no count, mean or centring)",
        bytes=s * (Lx * Cx * Bx + Lx * Cx + Cx + Cx * Bx + Cx * Bx * Bx),
        # S is symmetric: B(B+1)/2 multiply-adds per line; the mean pass
        # and the centring add 4 operations per element, the count one per
        # line
        ops=Lx * Cx * Bx * (Bx + 1) + 4 * Lx * Cx * Bx + Lx * Cx)
    del xc, got, ref

    # K2 LOOCV sweep
    got = loo.loo_sweep(Z, inv_glam, beta, m)
    torch.cuda.synchronize()
    ref = loo.loo_sweep_ref(Z, inv_glam, beta, m)
    if not torch.equal(got[1], ref[1]):
        fail(f"loo_sweep {name}: q_ok differs from the plain version")
    if ref[1].all() or not ref[1].any():
        fail(f"loo_sweep {name}: inputs do not exercise both q_ok outcomes")
    z2 = Z * Z
    k2 = dict(
        max_abs_err=(got[0] - ref[0]).abs().max().item(),
        max_rel_err=((got[0] - ref[0]).abs().max() / ref[0].abs().max()).item(),
        bit_identical=bit_identical(lambda: loo.loo_sweep(Z, inv_glam, beta, m)),
        argmin_other_columns=loo_argmin_check(got, ref, parts, tol),
        ms=cuda_ms(lambda: loo.loo_sweep(Z, inv_glam, beta, m)),
        plain_ms=cuda_ms(lambda: loo.loo_sweep_ref(Z, inv_glam, beta, m), reps=3),
        library_ms=cuda_ms(lambda: torch.einsum("lcb,cba->lca", z2, inv_glam), reps=3),
        library_call="einsum lcb,cba->lca: the product r alone, written to device "
                     "memory (no q, log, division, line sum or flag)",
        bytes=s * (Lx * Cx * Bx + Cx * Bx * Ax + Cx * Ax + Lx * Cx + Cx * Ax) + Cx * Ax,
        ops=2 * Lx * Cx * Bx * Ax + 7 * Lx * Cx * Ax)
    del z2, got, ref
    out = {}
    for kname, k in (("masked_moments", k1), ("loo_sweep", k2)):
        if not k["max_rel_err"] <= tol:
            fail(f"{kname} {name}: relative error {k['max_rel_err']:.3g} > {tol:g}")
        if not k["bit_identical"]:
            fail(f"{kname} {name}: two launches on one input differ")
        t_bytes = k["bytes"] / PEAK_BYTES * 1e3
        t_ops = k["ops"] / PEAK_FLOPS[dname] * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        k["tol"] = tol
        k["shape"] = [Lx, Cx, Bx, Ax]
        out[(kname, name)] = k
    return out


# shapes off the CH4 chunk's paths: (L, C, B, A, rows unaligned): the CO2
# (82) and reflectance (415) windows (band chunks, alpha groups, rows of
# no whole 16-byte vectors), unaligned rows (element copies), one line
ODD_SHAPES = ((300, 5, 82, 201, False), (300, 5, 415, 201, False),
              (130, 3, 72, 201, True), (1, 2, 72, 7, False), (37, 3, 10, 5, True))


def odd_shape_checks():
    """Both CMF kernels against their plain versions at ODD_SHAPES in f32
    and f64 (TOL), on seeded inputs with a column of no valid line and one
    of a single valid line; the last column's steep beta drives q far
    below 0, so q_ok takes both values."""
    import torch
    from srcfinder_torch.ops import loo, moments
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for dtype, dname in ((torch.float32, "float32"), (torch.float64, "float64")):
        for Lx, Cx, Bx, Ax, unaligned in ODD_SHAPES:
            def rows(t):
                return t[..., 1:] if unaligned else t[..., :Bx].contiguous()
            x = rows(torch.rand(Lx, Cx, Bx + 1, generator=gen, device="cuda", dtype=dtype) + 1)
            m = (torch.rand(Lx, Cx, generator=gen, device="cuda") > 0.1).to(dtype)
            m[:, 0] = 0.0
            m[:, 1] = 0.0
            m[Lx // 2, 1] = 1.0
            Z = rows(torch.randn(Lx, Cx, Bx + 1, generator=gen, device="cuda", dtype=dtype))
            ig = torch.rand(Cx, Bx, Ax, generator=gen, device="cuda", dtype=dtype) / Bx
            beta = torch.rand(Cx, Ax, generator=gen, device="cuda", dtype=dtype) * 0.3
            beta[-1] *= 1e9
            errs = {}
            for kname, got, ref in (
                    ("masked_moments", moments.masked_moments(x, m), moments.masked_moments_ref(x, m)),
                    ("loo_sweep", loo.loo_sweep(Z, ig, beta, m), loo.loo_sweep_ref(Z, ig, beta, m))):
                if kname == "loo_sweep":
                    if not torch.equal(got[1], ref[1]):
                        fail(f"loo_sweep {dname} {Lx}x{Cx}x{Bx}x{Ax}: q_ok differs")
                    got, ref = got[:1], ref[:1]
                errs[kname] = max(((g - r).abs().max() / r.abs().max().clamp(min=1e-300)).item()
                                  for g, r in zip(got, ref))
                if not errs[kname] <= TOL[dname]:
                    fail(f"{kname} {dname} {Lx}x{Cx}x{Bx}x{Ax} unaligned={unaligned}: "
                         f"relative error {errs[kname]:.3g} > {TOL[dname]:g}")
            out[f"{dname} {Lx}x{Cx}x{Bx}x{Ax}{' unaligned' if unaligned else ''}"] = errs
    print(json.dumps({"cmf_odd_shapes": out}))


def phase_kernels():
    """The CMF kernels against their plain versions: one full column chunk
    in float32 and float64, and 8 of its columns in float64 (the
    cond-gated recompute's shape, "float64_c8")."""
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    cmf_ms = {}
    for dtype, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        x, m, Rw, Z, inv_glam, beta, parts = chunk_inputs(dtype, gen)
        alphas = torch.as_tensor(mfmod.default_alphas(), dtype=dtype, device="cuda")
        abscf = torch.full((B,), -0.05, dtype=dtype, device="cuda")
        Zc = Z.permute(1, 0, 2)
        cmf_ms[name] = dict(
            eigh=eigh_probe(Rw, gen),
            whiten_bmm=cuda_ms(lambda: torch.bmm(Zc, Rw)),
            matched_filter_columns=cuda_ms(
                lambda: mfmod.matched_filter_columns(x, m, abscf, alphas), reps=3))
        results.update(cmf_kernel_checks(name, x, m, Z, inv_glam, beta, parts))
        if dtype == torch.float64:
            results.update(cmf_kernel_checks(
                "float64_c8", *c8_inputs(x, m, Z, inv_glam, beta, parts)))
        del x, m, Rw, Z, Zc, inv_glam, beta, parts
        torch.cuda.empty_cache()
    print(json.dumps({"cmf_chunk_ms": cmf_ms, "chunk": [L, C, B, A]}))
    odd_shape_checks()
    return results


def max_abs_diff(a, b, rows=256):
    """max |a - b| in f32, over slices of ``rows`` along dim 0."""
    return max((a[i:i + rows].float() - b[i:i + rows].float()).abs().max().item()
               for i in range(0, a.shape[0], rows))


def phase_conv_shapes():
    """Every distinct bf16 conv of trunk_s23 and trunk_s45 at the CLI's
    configuration, in the sub-batch each segment launches, through the
    single-conv entry as the segment launches it (channel offsets, pixel
    strides, split) on NaN-filled outputs, against the plain conv:
    relative error, ms, achieved TFLOP/s and the tile the dispatch picked
    (trunk_fuse.conv_tile). Each must go to the tensor-core kernel as
    trunk_fuse.tensor_core_ok says, stay within TRUNK_TOL["bfloat16"] and
    leave every channel it does not own NaN."""
    import torch
    from srcfinder_torch.ops import trunk_fuse as tf
    bf16, nan = torch.bfloat16, float("nan")
    gen = torch.Generator(device="cuda").manual_seed(3232)
    rows, seen = [], set()
    for name, side in (("trunk_s23", WIN // 2), ("trunk_s45", WIN // 16)):
        n = tf.sub_batch(name, CLI_BATCH, side, bf16)
        for c in tf.conv_plan(name, side):
            if c[1:] in seen:
                continue
            seen.add(c[1:])
            tag = f"{name} {c.layer}"
            if not tf.tensor_core_ok(c):
                fail(f"{tag}: outside the tensor-core kernel's dispatch rule")
            fan_in = c.k * c.k * c.cin
            ks = (c.cin, c.cout) if c.k == 1 else (c.k, c.k, c.cin, c.cout)
            k = (torch.randn(ks, generator=gen, device="cuda") * fan_in ** -0.5).to(bf16)
            b = (torch.randn(1, c.cout, generator=gen, device="cuda") * 0.2).to(bf16)
            X = torch.randn(n, c.side, c.side, c.ldx, generator=gen, device="cuda",
                            dtype=bf16).relu_()
            ho = (c.side + 2 * c.pad - c.k) // c.stride + 1
            Y0 = torch.full((n, ho, ho, c.ldy0), nan, device="cuda", dtype=bf16)
            Y1 = (torch.full((n, ho, ho, c.ldy1), nan, device="cuda", dtype=bf16)
                  if c.split < c.cout else None)
            x = X[..., c.x_off:c.x_off + c.cin]
            y0 = Y0[..., c.y_off:c.y_off + c.split]
            y1 = None if Y1 is None else Y1[..., :c.cout - c.split]

            def run():
                tf.conv(x, k, b, y0, y1, c.stride, c.pad)
            tile = tf.conv_tile(x, k, b, y0, y1, c.stride, c.pad)
            if tile not in (64, 128):
                fail(f"{tag}: the dispatch picked tile {tile}, not the tensor-core kernel")
            run()
            torch.cuda.synchronize()
            with torch.no_grad():
                ref = tf._conv_ref(x.permute(0, 3, 1, 2), k, b, c.stride, c.pad
                                   ).permute(0, 2, 3, 1)
                got = y0 if y1 is None else torch.cat([y0, y1], dim=3)
                ref_max = ref.float().abs().max().item()
                rel = max_abs_diff(got, ref) / ref_max
                untouched = int(torch.isnan(Y0).sum().item()) + (
                    0 if Y1 is None else int(torch.isnan(Y1).sum().item()))
            del ref, got
            ms = cuda_ms(run, reps=5)
            m = n * ho * ho
            ops = 2 * m * c.cout * fan_in
            rows.append(dict(conv=tag, windows=n, side=c.side, cin=c.cin, cout=c.cout,
                             k=c.k, M=m, ms=ms, tflops=ops / ms / 1e9, max_rel_err=rel,
                             ref_max=ref_max, tile=tile))
            want = m * (c.ldy0 - c.split + (0 if Y1 is None else c.ldy1 - (c.cout - c.split)))
            if not rel <= TRUNK_TOL["bfloat16"]:
                fail(f"{tag}: relative error {rel:.3g} > {TRUNK_TOL['bfloat16']:g}")
            if untouched != want:
                fail(f"{tag}: {untouched} NaN left in the outputs, expected {want} "
                     "(channels it does not own, none it does)")
            del X, Y0, Y1, x, y0, y1, k, b
        torch.cuda.empty_cache()
    # every M above is a multiple of the kernel's 128-row tile; trunk_s45 on
    # 3 windows gives inception 5a/5b (8 x 8 maps) 192 rows, a ragged tile
    params = [(torch.randn(s, generator=gen, device="cuda")
               * (0.2 if s[0] == 1 else math.prod(s[:-1]) ** -0.5)).to(bf16)
              for s in tf._SHAPES["trunk_s45"]]
    p45 = tf.pack_params("trunk_s45", params)
    x45 = torch.randn(3, WIN // 16, WIN // 16, 480, generator=gen, device="cuda",
                      dtype=bf16).relu_()
    with torch.no_grad():
        got, ref = tf.trunk_s45(x45, p45), tf.trunk_s45_ref(x45, p45)
    ragged = max_abs_diff(got, ref) / ref.float().abs().max().item()
    print(json.dumps({"conv_shapes": rows, "tol": TRUNK_TOL["bfloat16"],
                      "trunk_s45_b3_max_rel_err": ragged}))
    if not ragged <= TRUNK_TOL["bfloat16"]:
        fail(f"trunk_s45 on 3 windows: relative error {ragged:.3g}")
    return rows


def seeded_params(gen, name, dtype):
    """Weights of entry point ``name`` of the trunk kernels from ``gen``:
    kernels std sqrt(1 / fan_in), biases std 0.2."""
    import torch
    from srcfinder_torch.ops import trunk_fuse as tf
    return [(torch.randn(s, generator=gen, device="cuda")
             * (0.2 if s[0] == 1 else math.prod(s[:-1]) ** -0.5)).to(dtype)
            for s in tf._SHAPES[name]]


def stage12_layer_work(n, d):
    """{layer: (operations, elements moved)} of P2's three launches over n
    windows of side d: the front kernel (window in, conv2's map out,
    conv1's and conv2's weights), conv3 (conv2's map in, its own out,
    weights) and pool2."""
    o1, h, w1 = _conv_count(n, d, 1, 64, 7, 2)
    p1, h = _pool_count(n, h, 64, 3, 2)
    o2, _, w2 = _conv_count(n, h, 64, 64, 1)
    o3, _, w3 = _conv_count(n, h, 64, 192, 3)
    p2, h2 = _pool_count(n, h, 192, 3, 2)
    c2, c3 = n * h * h * 64, n * h * h * 192
    return {"front": (o1 + p1 + o2, n * d * d + c2 + w1 + w2), "conv3": (o3, c2 + c3 + w3),
            "pool2": (p2, c3 + n * h2 * h2 * 192)}


def stage12_layers():
    """P2's launches one by one (phase 2): device ms of the front kernel,
    conv3 and pool2 in one profiled fused_stage12 call, in each of
    TRUNK_CONFIGS, on seeded windows and weights, each beside its bound."""
    import torch
    from srcfinder_torch.ops import trunk_fuse as tf
    gen = torch.Generator(device="cuda").manual_seed(1212)
    family = {"front": ("front_kernel",), "conv3": ("conv_wgmma_kernel", "conv_kernel"),
              "pool2": ("maxpool_kernel",)}
    out = {}
    for dname, n in TRUNK_CONFIGS:
        dtype = getattr(torch, dname)
        p = tf.pack_params("fused_stage12", seeded_params(gen, "fused_stage12", dtype))
        wins = torch.randn(n, WIN, WIN, 1, generator=gen, device="cuda").to(dtype)
        with torch.no_grad():
            tf.fused_stage12(wins, p)
            prof = device_profile(lambda: tf.fused_stage12(wins, p))
        layers = {}
        for layer, (ops, elems) in stage12_layer_work(n, WIN).items():
            ms = sum(prof["families_ms"].get(f, 0.0) for f in family[layer])
            bound = max(elems * (torch.finfo(dtype).bits // 8) / PEAK_BYTES,
                        ops / PEAK_FLOPS[dname]) * 1e3
            layers[layer] = dict(ms=ms, bound_ms=bound, share_of_bound=bound / ms if ms else None)
        out[f"{dname}_b{n}"] = dict(layers=layers, device_busy_ms=prof["device_busy_ms"],
                                    families_ms=prof["families_ms"])
        if not all(v["ms"] > 0 for v in layers.values()):
            fail(f"fused_stage12 {dname}_b{n}: the profile misses a launch: {prof['top']}")
        del wins, p
        torch.cuda.empty_cache()
    print(json.dumps({"stage12_layers": out, "window": WIN}))


def write_scene(workdir, gen, name="ang20200924t211102_rdn_v2y1_img", modes=False):
    """Seeded AVIRIS-NG-shaped radiance (BIL f32) with a plume in the CH4
    window, written in line blocks; plus the CH4 unit-absorption library.
    ``modes``: two background modes, the first half of the lines raised by
    MODE_OFFSET in every band (tests/test_cmf_pipeline.py:259)."""
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import create_envi
    nl, ns, nb = SCENE
    meta = {"lines": nl, "samples": ns, "bands": nb, "interleave": "bil",
            "data type": 4, "byte order": 0, "header offset": 0,
            "data ignore value": -9999,
            "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1",
                         "3.1", "11", "North", "WGS-84", "units=Meters",
                         "rotation=0"],
            "wavelength": [f"{w:.2f}" for w in np.linspace(380, 2500, nb)]}
    rdn = os.path.join(workdir, name)
    img = create_envi(rdn + ".hdr", meta)
    mm = img.open_memmap(interleave="source", writable=True)   # (L, bands, S)
    absorb = torch.ones(nb, device="cuda")
    absorb[360:410] = 0.9
    for r0 in range(0, nl, 256):
        r1 = min(nl, r0 + 256)
        blk = (torch.randn(r1 - r0, ns, nb, generator=gen, device="cuda")
               * 0.5 + 4.0).abs_().add_(0.5)
        if modes:
            blk[:max(0, min(r1, nl // 2) - r0)] += MODE_OFFSET
        lo, hi = max(r0, PLUME[0].start), min(r1, PLUME[0].stop)
        if lo < hi:
            blk[lo - r0:hi - r0, PLUME[1]] *= absorb
        if r0 == 0:
            blk[0, :3] = -9999.0                               # nodata pixels
        mm[r0:r1] = blk.permute(0, 2, 1).cpu().numpy()
    mm.flush()
    del mm
    lrng = np.random.default_rng(1234)
    lib = np.zeros((nb, 3))
    lib[:, 0] = np.arange(1, nb + 1)
    lib[:, 1] = np.linspace(380, 2500, nb)
    lib[:, 2] = -np.abs(lrng.normal(size=nb)) * 0.1
    libf = os.path.join(workdir, "ang_ch4_unit_3col_425chan.txt")
    np.savetxt(libf, lib)
    return rdn, libf


def write_weights(workdir):
    import torch
    from srcfinder_torch.models.convert import save_weights, torch_state_dict_to_flax
    from srcfinder_torch.models.googlenet import GoogLeNet
    model = GoogLeNet(num_classes=2, generator=torch.Generator().manual_seed(0))
    wf = os.path.join(workdir, "googlenet_seed0.npz")
    save_weights(wf, torch_state_dict_to_flax(model.state_dict()))
    return wf


def phase_main_path(workdir):
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.flow.pipeline_cli import run_flightline
    from srcfinder_torch.ops import loo, moments

    gen = torch.Generator(device="cuda").manual_seed(2801)
    t0 = time.time()
    rdn, libf = write_scene(workdir, gen)
    wf = write_weights(workdir)
    setup_s = time.time() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    t0 = time.time()
    prods = run_flightline(rdn, libf, wf, os.path.join(workdir, "out"),
                           prob_thr=0.0, do_ime=True, device="cuda",
                           progress=lambda msg: print(msg, flush=True))
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"masked_moments": moments.KERNEL.launches,
                "loo_sweep": loo.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()

    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    cmf = open_envi(prods["cmf"]).load()
    if cmf.shape != (SCENE[0], SCENE[1], 4):
        fail(f"CMF product shape {cmf.shape}")
    ppmm = cmf[..., 3]
    valid = ppmm != -9999.0
    if not (ppmm[0, :3] == -9999.0).all() or not np.isfinite(ppmm[valid]).all():
        fail("CMF nodata stamp or finiteness")
    plume = ppmm[PLUME].mean()
    bg = ppmm[valid].mean()
    bg_sd = ppmm[valid].std()
    z = (plume - bg) / (bg_sd / np.sqrt(ppmm[PLUME].size))
    if not z > 10:
        fail(f"plume mean ppm*m {plume:.1f} does not stand out of the "
             f"background {bg:.1f} (sd {bg_sd:.1f}): z = {z:.1f}")
    sal = open_envi(prods["saliency"]).load()[..., 0]
    sval = sal != -9999.0
    if not (sal[0, :3] == -9999.0).all() or sval.sum() != SCENE[0] * SCENE[1] - 3:
        fail("saliency nodata stamp")
    if not ((sal[sval] >= 0) & (sal[sval] <= 1)).all():
        fail("saliency outside [0, 1]")
    for key in ("detections_csv", "detections_xlsx", "ime_csv"):
        if not prods.get(key) or not os.path.exists(prods[key]):
            fail(f"missing product {key}")
    import pandas as pd
    ime = pd.read_csv(prods["ime_csv"])
    if len(ime) == 0 or not (ime["ime_kg"] > 0).all():
        fail("IME stats empty")
    summary = dict(scene=list(SCENE), setup_s=setup_s, run_s=total_s,
                   stage_s=prods["timers"], launches=launches,
                   peak_mem_bytes=peak, plume_ppmm=float(plume),
                   background_ppmm=float(bg), background_sd=float(bg_sd),
                   plume_z=float(z),
                   n_candidates=len(pd.read_csv(prods["detections_csv"])),
                   ime_rows=len(ime))
    print(json.dumps({"main_path": summary}))
    profile_stages(rdn, libf, wf, prods["cmf"], workdir)
    return launches, prods["cmf"], rdn, libf


def multimodal_chunk_inputs(x_active, dtype):
    """The multimodal run's last column chunk (its 86 scene columns padded
    with zero columns to C, as robust_mf_image pads it) in ``dtype``, and
    the kernels' inputs of its mode-1 fit as the multimodal path builds
    them: k-means labels from the port's own PCA and seeding, the mode's
    mask (about half of each scene column's rows; none in the padded
    columns, where every point is 0 and k-means puts all in mode 0) and
    beta from the full column's count (n_loo). The steep beta of
    ``chunk_inputs`` goes on 8 scene columns, so q_ok takes both values."""
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod
    from srcfinder_torch.cmf.kmeans import kmeans_columns, masked_pca_project
    c0 = (SCENE[1] - 1) // C * C
    x = x_active[:, c0:].to(dtype)
    x = torch.cat([x, x.new_zeros(x.shape[0], C - x.shape[1], x.shape[2])], dim=1)
    m = mfmod.valid_mask(x).to(dtype)
    x = torch.where(m.bool()[:, :, None], x, torch.zeros((), dtype=dtype, device="cuda"))
    labels, _ = kmeans_columns(masked_pca_project(x, m, 6), m, 2)
    mask = (m.bool() & (labels == 1)).to(dtype)
    Rw, Z, inv_glam, beta, parts = sweep_inputs(x, mask, n_loo=m.sum(dim=0))
    beta[:8] *= 1e9
    counts = mask.sum(dim=0)
    return (x, mask, Z, inv_glam, beta, parts), dict(
        scene_columns=SCENE[1] - c0, empty_mode_columns=int((counts == 0).sum()),
        mode_rows_median=float(counts[:SCENE[1] - c0].median()))


def phase_multimodal(workdir, libf, wf):
    """Phase 4b: the multimodal CMF on a two-mode scene (MODE_OFFSET):
    run_flightline(bgmodes=2) with IME (launch counts zeroed just before,
    read just after; K1/K2 and eigh launches, f64-gated columns), the CMF
    CLI with -k 3 -r -f -m, and the bgmodes=2 CMF in f64 on the card with
    its labels. Checks the labels, the f32 map against the f64 one, the
    plume's z, and K1/K2 at the run's mode-1 masks and n_loo against
    their plain versions. Returns (launches, kernel checks)."""
    import numpy as np
    import torch
    from srcfinder_torch.cmf import pipeline as tpl
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.flow.pipeline_cli import run_flightline
    from srcfinder_torch.ops import loo, moments

    gen = torch.Generator(device="cuda").manual_seed(2802)
    t0 = time.time()
    rdn, _ = write_scene(workdir, gen, name="ang20200924t213000_rdn_v2y1_img", modes=True)
    setup_s = time.time() - t0
    nl, ns, _ = SCENE
    nblocks = -(-ns // C)

    # count eigh calls and the f64 gate's columns during the run
    calls = {"eigh": 0, "f64_columns": 0}
    eigh, f64_cols = torch.linalg.eigh, tpl._f64_columns_multimodal

    def count_eigh(*a, **k):
        calls["eigh"] += 1
        return eigh(*a, **k)

    def count_f64(xblk, cols, *a, **k):
        calls["f64_columns"] += len(cols)
        return f64_cols(xblk, cols, *a, **k)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    torch.linalg.eigh, tpl._f64_columns_multimodal = count_eigh, count_f64
    try:
        t0 = time.time()
        prods = run_flightline(rdn, libf, wf, os.path.join(workdir, "out_mm"), prob_thr=0.0,
                               do_ime=True, bgmodes=2, device="cuda",
                               progress=lambda msg: print(msg, flush=True))
        torch.cuda.synchronize()
        run_s = time.time() - t0
    finally:
        torch.linalg.eigh, tpl._f64_columns_multimodal = eigh, f64_cols
    peak = torch.cuda.max_memory_allocated()
    launches = {"masked_moments": moments.KERNEL.launches, "loo_sweep": loo.KERNEL.launches}
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the multimodal path")

    # the CLI's whole multimodal flag set, in a process of its own
    torch.cuda.empty_cache()
    out_k3 = os.path.join(workdir, "cmf_k3")
    t0 = time.time()
    cli = subprocess.run([sys.executable, "-m", "srcfinder_torch.cmf.cli", rdn, libf, out_k3,
                          "-k", "3", "-r", "-f", "-m"], cwd=HERE, capture_output=True,
                         text=True, timeout=600)
    cli_s = time.time() - t0
    if cli.returncode != 0:
        fail(f"cmf.cli -k 3 -r -f -m failed:\n{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
    k3 = open_envi(out_k3)
    k3_ppmm = k3.load()[..., 3]
    k3_labels = open_envi(out_k3 + "_bgmeta").load()[..., 0]
    if "bgmodes=3" not in ",".join(k3.metadata["model parameters"]):
        fail(f"cmf.cli -k 3 header: {k3.metadata['model parameters']}")
    if not (np.isfinite(k3_ppmm).all() and set(np.unique(k3_labels)) <= {0, 1, 2}):
        fail("cmf.cli -k 3: non-finite map or labels outside 0..2")

    # the same CMF in f64 on the card, with its labels
    out64 = os.path.join(workdir, "cmf_mm_f64")
    t0 = time.time()
    res64 = tpl.robust_mf_image(rdn, libf, out64, bgmodes=2, dtype=np.float64,
                                save_bgmeta=True, device="cuda")
    torch.cuda.synchronize()
    f64_s = time.time() - t0

    ppmm = open_envi(prods["cmf"]).load()[..., 3]
    ppmm64 = open_envi(out64).load()[..., 3]
    labels = open_envi(out64 + "_bgmeta").load()[..., 0]
    valid = ppmm64 != -9999.0
    if not np.array_equal(valid, ppmm != -9999.0) or not np.isfinite(ppmm[valid]).all():
        fail("multimodal: f32 and f64 maps disagree on validity, or f32 not finite")
    if not (ppmm[0, :3] == -9999.0).all():
        fail("multimodal: nodata stamp")
    true = (np.arange(nl) < nl // 2)[:, None]
    agree = ((labels == 0) == true) & valid
    agree = agree.sum(axis=0) / valid.sum(axis=0)
    agree = np.maximum(agree, 1.0 - agree)
    err = np.abs(ppmm[valid] - ppmm64[valid]).max() / np.abs(ppmm64[valid]).max()
    plume = ppmm[PLUME].mean()
    bg, bg_sd = ppmm[valid].mean(), ppmm[valid].std()
    z = (plume - bg) / (bg_sd / np.sqrt(ppmm[PLUME].size))

    # K1 and K2 at this run's mode masks and n_loo
    x_active = torch.from_numpy(np.ascontiguousarray(
        open_envi(rdn).read_band_window(350, 422).transpose(0, 2, 1))).to("cuda")
    checks, chunk = {}, None
    for dtype, name in ((torch.float32, "multimodal"), (torch.float64, "multimodal_float64")):
        inputs, chunk = multimodal_chunk_inputs(x_active, dtype)
        x, mask, Z, ig, beta, parts = inputs
        checks.update(cmf_kernel_checks(name, x, mask, Z, ig, beta, parts))
        del inputs, x, mask, Z, ig, beta, parts
        torch.cuda.empty_cache()
    del x_active
    for f in (rdn, rdn + ".hdr"):
        os.remove(f)

    summary = dict(
        scene=list(SCENE), mode_offset=MODE_OFFSET, setup_s=setup_s, run_s=run_s,
        stage_s=prods["timers"], peak_mem_bytes=peak, launches=launches,
        per_chunk=dict(chunks=nblocks, masked_moments=launches["masked_moments"] / nblocks,
                       loo_sweep=launches["loo_sweep"] / nblocks,
                       eigh=calls["eigh"] / nblocks),
        f64_gate_columns=calls["f64_columns"], cli_k3_s=cli_s, cmf_f64_s=f64_s,
        f64_gate_columns_in_f64_run=res64["f64_columns"],
        label_agreement_min=float(agree.min()), f32_vs_f64_rel=float(err),
        plume_z=float(z), plume_ppmm=float(plume), background_ppmm=float(bg),
        background_sd=float(bg_sd), kernel_chunk=chunk,
        kernels={k[0] + ("" if k[1] == "multimodal" else "_f64"):
                 {f: v[f] for f in ("max_rel_err", "bit_identical", "ms", "plain_ms")}
                 for k, v in checks.items()})
    print(json.dumps({"multimodal": summary}))
    if not agree.min() > LABEL_AGREEMENT:
        fail(f"multimodal: k-means labels agree with the two modes on only "
             f"{agree.min():.4f} of a column's pixels")
    if not err < MM_F32_TOL:
        fail(f"multimodal: f32 map {err:.3g} of the f64 map's maximum from it")
    if not z > 10:
        fail(f"multimodal: plume z = {z:.1f}")
    return launches, checks


_PROFILER_MARKERS = ("Buffer Flush", "Activity Buffer Request")


def branch4_ms(events):
    """Device ms of the trunk kernels' inception branch 4 (its 3x3/1 pool
    and the 1x1 after it) in time-ordered device ``events``: each block
    launches conv (wide 1x1), conv, conv, pool, conv, and no other pool
    of the trunk follows three convs."""
    kind = ["conv" if "conv_kernel" in e.name or "conv_wgmma_kernel" in e.name
            else "pool" if "maxpool_kernel" in e.name else "" for e in events]
    return sum(events[i].time_range.elapsed_us() + events[i + 1].time_range.elapsed_us()
               for i in range(3, len(events) - 1)
               if kind[i] == "pool" and kind[i - 3:i] == ["conv"] * 3
               and kind[i + 1] == "conv") / 1e3


# device functions by family: the first pattern a name matches; cuDNN's
# convolutions and its layout transposes are "cudnn_conv"
KERNEL_FAMILIES = (("front_kernel", r"front_kernel"), ("conv_wgmma_kernel", r"conv_wgmma_kernel"),
                   ("conv_kernel", r"conv_kernel"), ("maxpool_kernel", r"maxpool_kernel"),
                   ("gap_kernel", r"gap_kernel"),
                   ("cudnn_conv", r"fprop|dgrad|wgrad|convolve|cudnn|nchwToNhwc|nhwcToNchw|"
                                  r"implicit_gemm|conv2d|xmma_conv"),
                   ("torch_pool", r"max_pool|pooling"), ("gemm", r"gemm"),
                   ("copy", r"^Memcpy|^Memset"))


def kernel_family(name):
    return next((f for f, pat in KERNEL_FAMILIES if re.search(pat, name)), "other")


def device_profile(fn):
    """One profiled call of ``fn()``: wall time, device-busy time (sum of
    kernel and copy time), idle share, peak memory, the busiest device
    functions, device ms by KERNEL_FAMILIES and the trunk kernels' branch
    4 (``branch4_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device-side events only (kernels and copies), summed per name; the
    # CUPTI buffer markers are the profiler's own overhead
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and e.name not in _PROFILER_MARKERS), key=lambda e: e.time_range.start)
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k[:90], t, n) for k, (t, n) in by_name.items()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    families = {}
    for k, (t, _) in by_name.items():
        f = kernel_family(k)
        families[f] = families.get(f, 0.0) + t
    b4 = branch4_ms(events)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                peak_mem_bytes=torch.cuda.max_memory_allocated(), top=rows[:12],
                families_ms=families, branch4_ms=b4, branch4_share=b4 / busy_ms)


def profile_stages(rdn, libf, wf, cmf_product, workdir):
    """Second, profiled pass over the same scene, one profile per device
    stage (CMF, FCN)."""
    import numpy as np
    from srcfinder_torch.cmf.pipeline import robust_mf_image
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect.fcn_pipeline import (fcn_saliency_image,
                                                     load_saliency_model)

    def cmf():
        robust_mf_image(rdn, libf, os.path.join(workdir, "prof_cmf"), device="cuda")

    band = np.asarray(open_envi(cmf_product).read_band(-1), np.float32)
    model = load_saliency_model(wf, device="cuda")

    def fcn():
        fcn_saliency_image(band, model, device="cuda").cpu()

    out = {name: device_profile(fn) for name, fn in (("cmf", cmf), ("fcn", fcn))}
    print(json.dumps({"profile": out}))


def write_cnn_weights(workdir):
    """GoogLeNet weights that keep the trunk's activations O(1): conv and
    fc std sqrt(1 / fan_in), BatchNorm affine and running stats perturbed
    as after training (the default init's std 0.01 collapses activations
    towards 0 and every probability towards 0.5, where a kernel's
    agreement with its plain version would prove little)."""
    import torch
    from torch import nn
    from srcfinder_torch.models.convert import save_weights, torch_state_dict_to_flax
    from srcfinder_torch.models.googlenet import GoogLeNet
    gen = torch.Generator().manual_seed(256)
    model = GoogLeNet(num_classes=2, generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5, generator=gen)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.2, generator=gen)
                mod.running_mean.normal_(0.0, 0.2, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    wf = os.path.join(workdir, "googlenet_trained_like.npz")
    save_weights(wf, torch_state_dict_to_flax(model.state_dict()))
    return wf


def write_strip(workdir, cmf_product):
    """One-band ENVI strip of STRIP_LINES lines through the plume of the
    scene's CMF ppm*m band, with three nodata pixels."""
    import numpy as np
    from srcfinder_torch.core.envi import open_envi, save_envi
    r0 = (PLUME[0].start + PLUME[0].stop - STRIP_LINES) // 2
    strip = np.array(open_envi(cmf_product).load()[r0:r0 + STRIP_LINES, :, 3])
    strip[0, :3] = -9999.0
    path = os.path.join(workdir, "ang20200924t211102_ch4mf_strip")
    save_envi(path + ".hdr", strip[:, :, None],
              metadata={"data ignore value": -9999, "map info": [
                  "UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1", "11",
                  "North", "WGS-84", "units=Meters", "rotation=0"]})
    return path


def _conv_count(n, h, cin, cout, k, s=1):
    """(operations, output side, weight elements) of a conv + bias + ReLU:
    2 per multiply-add, 2 per output for bias and ReLU."""
    ho = (h + 2 * (k // 2) - k) // s + 1
    return 2 * n * ho * ho * cout * (k * k * cin + 1), ho, k * k * cin * cout + cout


def _pool_count(n, h, c, k, s):
    """(comparisons, output side) of a k x k max pool (ceil mode)."""
    ho = (h - k + s - 1) // s + 1 if s > 1 else h
    return n * ho * ho * c * k * k, ho


def _inception_count(n, h, plan):
    from srcfinder_torch.ops.trunk_fuse import _INCEPTION, _cin
    ch1, red3, ch3, red5, ch5, proj = _INCEPTION[plan]
    cin = _cin(plan)
    parts = [_conv_count(n, h, cin, ch1 + red3 + red5, 1),
             _conv_count(n, h, red3, ch3, 3), _conv_count(n, h, red5, ch5, 3),
             _conv_count(n, h, cin, proj, 1)]
    return (sum(p[0] for p in parts) + _pool_count(n, h, cin, 3, 1)[0],
            sum(p[2] for p in parts), ch1 + ch3 + ch5 + proj)


def trunk_work(name, n, d):
    """Operations and element counts (input, output, weights) of one
    trunk kernel over n windows of side d, from the layer shapes."""
    from srcfinder_torch.ops.trunk_fuse import _BLOCKS
    ops = wts = 0
    if name == "fused_stage12":
        o1, h, w1 = _conv_count(n, d, 1, 64, 7, 2)
        p1, h = _pool_count(n, h, 64, 3, 2)
        o2, _, w2 = _conv_count(n, h, 64, 64, 1)
        o3, _, w3 = _conv_count(n, h, 64, 192, 3)
        p2, h = _pool_count(n, h, 192, 3, 2)
        return o1 + p1 + o2 + o3 + p2, n * d * d, n * h * h * 192, w1 + w2 + w3
    if name == "trunk_s3":
        g = h = d // 8
        c = 192
        for blk in _BLOCKS["s3"]:
            o, w, c = _inception_count(n, h, blk)
            ops, wts = ops + o, wts + w
        p3, h = _pool_count(n, h, c, 3, 2)
        return ops + p3, n * g * g * 192, n * h * h * c, wts
    if name == "trunk_s23":
        h_in = h = d // 2
        p1, h = _pool_count(n, h, 64, 3, 2)
        o2, _, w2 = _conv_count(n, h, 64, 64, 1)
        o3, _, w3 = _conv_count(n, h, 64, 192, 3)
        p2, h = _pool_count(n, h, 192, 3, 2)
        ops, wts, c = p1 + o2 + o3 + p2, w2 + w3, 192
        for blk in _BLOCKS["s23"]:
            o, w, c = _inception_count(n, h, blk)
            ops, wts = ops + o, wts + w
        p3, h = _pool_count(n, h, c, 3, 2)
        return ops + p3, n * h_in * h_in * 64, n * h * h * c, wts
    g = h = d // 16
    for i, blk in enumerate(_BLOCKS["s45"]):
        if i == 5:
            p4, h = _pool_count(n, h, 832, 2, 2)
            ops += p4
        o, w, c = _inception_count(n, h, blk)
        ops, wts = ops + o, wts + w
    return ops + n * h * h * c, n * g * g * 480, n * 1024, wts


def phase_trunk_kernels(strip, wf):
    """The trunk kernels against their plain versions in each of
    TRUNK_CONFIGS, on windows of the preprocessed strip; weights packed
    once, as the window loop passes them. fused_stage12's gather form on
    the padded strip against its contiguous form, and P2 on 3 windows at
    each side of STAGE12_SMALL."""
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect.cnn_pipeline import reference_pad
    from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4
    from srcfinder_torch.device import resolve_device
    from srcfinder_torch.models.convert import load_weights
    from srcfinder_torch.models.googlenet import GoogLeNet, _ceil_maxpool, fold_inference
    from srcfinder_torch.ops import trunk_fuse as tf

    resolve_device("cuda")                     # TF32 off for the cuDNN sides
    band = torch.tensor(np.asarray(open_envi(strip).read_band(0), np.float32),
                        device="cuda")
    x = preprocess_ch4(band, *norm_for_model("COVID_QC"))
    scene = reference_pad(x, WIN)
    padded = scene.unfold(0, WIN, 1).unfold(1, WIN, 1)
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(load_weights(wf))
    model32 = fold_inference(model.eval()).cuda()

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous()

    results, small = {}, {}
    for dname, n in TRUNK_CONFIGS:
        dtype = getattr(torch, dname)
        m = model32.to(dtype)      # in place: TRUNK_CONFIGS runs float32 first
        sd = m.state_dict()
        idx = torch.linspace(0, x.numel() - 1, n, device="cuda").long()
        origins = torch.stack([idx // x.shape[1], idx % x.shape[1]], dim=1)
        wins = padded[origins[:, 0], origins[:, 1]].contiguous().to(dtype)
        plane = scene.to(dtype)
        params = {"fused_stage12": tf.pack_params("fused_stage12", tf.stage12_params(sd)),
                  "trunk_s23": tf.pack_params("trunk_s23", tf.trunk_segment_params(sd, "s23")),
                  "trunk_s3": tf.pack_params("trunk_s3", tf.trunk_segment_params(sd, "s3")),
                  "trunk_s45": tf.pack_params("trunk_s45", tf.trunk_segment_params(sd, "s45"))}
        with torch.no_grad():
            c1 = nhwc(m(wins[:, None], stage=1))
            x12 = tf.fused_stage12_ref(wins, params["fused_stage12"])
            x23 = tf.trunk_s23_ref(c1, params["trunk_s23"])
        cases = {
            "fused_stage12": (tf.fused_stage12, tf.fused_stage12_ref, wins[..., None].contiguous(),
                              lambda t: nhwc(_ceil_maxpool(m(m(nchw(t), stage=1), stage=2), 3, 2))),
            "trunk_s23": (tf.trunk_s23, tf.trunk_s23_ref, c1,
                          lambda t: nhwc(_ceil_maxpool(m(m(nchw(t), stage=2), stage=3), 3, 2))),
            "trunk_s3": (tf.trunk_s3, tf.trunk_s3_ref, x12,
                         lambda t: nhwc(_ceil_maxpool(m(nchw(t), stage=3, start_stage=3,
                                                        start_pooled=True), 3, 2))),
            "trunk_s45": (tf.trunk_s45, tf.trunk_s45_ref, x23,
                          lambda t: m(m(nchw(t), stage=4, start_stage=4, start_pooled=True),
                                      stage=5, start_stage=5).mean(dim=(2, 3)))}
        s = torch.finfo(dtype).bits // 8
        tag = f"{dname}_b{n}"
        for name in TRUNK_KERNELS:
            kern, plain, inp, library = cases[name]
            p = params[name]
            with torch.no_grad():
                got = kern(inp, p)
                torch.cuda.synchronize()
                ref = plain(inp, p)
                ref_max = ref.float().abs().max().item()
                abs_err = (got.float() - ref.float()).abs().max().item()
                k = dict(max_abs_err=abs_err, max_rel_err=abs_err / ref_max,
                         ref_max=ref_max, tol=TRUNK_TOL[dname],
                         bit_identical=bit_identical(lambda: (kern(inp, p),)),
                         ms=cuda_ms(lambda: kern(inp, p), reps=3),
                         plain_ms=cuda_ms(lambda: plain(inp, p), reps=3),
                         library_ms=cuda_ms(lambda: library(inp), reps=3))
                if name == "fused_stage12":
                    k["gather_equal"] = torch.equal(
                        tf.fused_stage12_gather(plane, origins, WIN, p), got)
                    k["gather_ms"] = cuda_ms(
                        lambda: tf.fused_stage12_gather(plane, origins, WIN, p), reps=3)
                del got, ref
            ops, n_in, n_out, n_w = trunk_work(name, n, WIN)
            k["ops"], k["bytes"] = ops, s * (n_in + n_out + n_w)
            t_bytes = k["bytes"] / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_FLOPS[dname] * 1e3
            k["bound_ms"] = max(t_bytes, t_ops)
            k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            if not k["max_rel_err"] <= TRUNK_TOL[dname]:
                fail(f"{name} {tag}: relative error {k['max_rel_err']:.3g} "
                     f"> {TRUNK_TOL[dname]:g}")
            if not k["bit_identical"]:
                fail(f"{name} {tag}: two launches on one input differ")
            if not k.get("gather_equal", True):
                fail(f"fused_stage12 {tag}: the gather form differs from the contiguous form")
            results[(name, tag)] = k
        del c1, x12, x23, cases, wins, params
        torch.cuda.empty_cache()
        if n == CLI_BATCH:
            continue
        # P2 on 3 windows (the strip's first, middle and last pixel) at
        # other window sides: the gather form against the contiguous form
        # and the plain version
        p = tf.pack_params("fused_stage12", tf.stage12_params(sd))
        org = origins[[0, n // 2, n - 1]]
        for d in STAGE12_SMALL:
            plane_d = reference_pad(x, d).to(dtype)
            with torch.no_grad():
                got = tf.fused_stage12_gather(plane_d, org, d, p)
                wins_d = tf._windows(plane_d, org, d)[..., None].contiguous()
                same = torch.equal(tf.fused_stage12(wins_d, p), got)
                ref = tf.fused_stage12_ref(wins_d, p)
            rel = max_abs_diff(got, ref) / ref.float().abs().max().item()
            small[f"{dname}_d{d}"] = dict(max_rel_err=rel, gather_equal=same)
            if not (rel <= TRUNK_TOL[dname] and same):
                fail(f"fused_stage12 {dname} on 3 windows of side {d}: relative error "
                     f"{rel:.3g}, gather form equal to the contiguous form: {same}")
    print(json.dumps({"trunk_kernels": {f"{n} {t}": v for (n, t), v in results.items()},
                      "stage12_3_windows": small, "window": WIN}))
    return results


def phase_exact_cnn(workdir, strip, wf):
    """The exact dense CNN on the strip: the CLI at its defaults (the main
    path), the other kernel route and the plain route in its
    configuration, each trunk route in f32, the segments route at the
    CLI's batch in f32, the fast method. Each run zeroes the trunk kernels'
    launch counters just before and reads them just after. Returns
    {kernel: (run, launches)} from the run of each kernel's path
    (kernel_run)."""
    import inspect
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect import cnn_cli
    from srcfinder_torch.detect.cnn_pipeline import TRUNKS, cnn_saliency_image
    from srcfinder_torch.models.convert import load_weights
    from srcfinder_torch.models.googlenet import GoogLeNet
    from srcfinder_torch.ops import trunk_fuse

    band = np.asarray(open_envi(strip).read_band(0), np.float32)
    nodata = band == -9999.0
    n_win = band.size
    model = GoogLeNet(num_classes=2)
    model.load_state_dict(load_weights(wf))
    out = os.path.join(workdir, "cnn_out")
    bf16 = torch.bfloat16
    default = inspect.signature(cnn_saliency_image).parameters["trunk"].default
    other = "segments" if default == "stage12" else "stage12"
    cli_tag = f"cli_bf16_{default}_b{CLI_BATCH}"

    def check(sal, what):
        if sal.shape != band.shape or not (sal[nodata] == -9999.0).all():
            fail(f"{what}: shape {sal.shape} or nodata stamp")
        v = sal[~nodata]
        if not (np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all()):
            fail(f"{what}: saliency not finite in [0, 1]")

    def saliency(**kw):
        return cnn_saliency_image(band, model, device="cuda", **kw).cpu().numpy()

    # warm-up on one line, at each configuration's batch (the tail batch is
    # padded to full size): cuDNN start-up and algorithm choice, first
    # launches; outside the counted runs
    for trunk in TRUNKS:
        cnn_saliency_image(band[:1], model, trunk=trunk, device="cuda")
        cnn_saliency_image(band[:1], model, batch=CLI_BATCH, dtype=bf16, trunk=trunk,
                           device="cuda")
    cnn_saliency_image(band[:1], model, batch=CLI_BATCH, trunk="segments", device="cuda")
    torch.cuda.synchronize()

    stats, sals = {}, {}

    def run(tag, fn, trunk):
        """``fn()`` with the launch counters zeroed just before and read
        just after; the kernels that launched must be those of ``trunk``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trunk_fuse.KERNEL.reset()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        s = time.time() - t0
        counts = {k: trunk_fuse.launches(k) for k in TRUNK_KERNELS}
        stats[tag] = dict(s=s, windows_per_s=n_win / s,
                          peak_mem_bytes=torch.cuda.max_memory_allocated(),
                          projected_full_scene_s=s * SCENE[0] / STRIP_LINES,
                          launches=counts, route=trunk)
        launched = sorted(k for k, c in counts.items() if c > 0)
        if launched != sorted(ROUTE_KERNELS[trunk]):
            fail(f"{tag}: launched {launched}, trunk {trunk} launches "
                 f"{sorted(ROUTE_KERNELS[trunk])}")
        return res

    rc = run(cli_tag, lambda: cnn_cli.main([strip, "-n", "1", "-w", wf, "-o", out]), default)
    if rc != 0:
        fail(f"cnn_cli exited {rc}")
    cli_sal = open_envi(os.path.join(out, os.path.basename(strip) + "_saliency")).load()[..., 0]
    check(cli_sal, "cnn_cli")
    sals[f"bf16_{other}_b{CLI_BATCH}"] = run(f"bf16_{other}_b{CLI_BATCH}", lambda: saliency(
        batch=CLI_BATCH, dtype=bf16, trunk=other), other)
    sals[f"bf16_plain_b{CLI_BATCH}"] = run(f"bf16_plain_b{CLI_BATCH}", lambda: saliency(
        batch=CLI_BATCH, dtype=bf16, trunk="plain"), "plain")
    for trunk in TRUNKS:
        sals[f"f32_{trunk}_b512"] = run(f"f32_{trunk}_b512", lambda: saliency(
            batch=512, trunk=trunk), trunk)
    sals[f"f32_segments_b{CLI_BATCH}"] = run(f"f32_segments_b{CLI_BATCH}", lambda: saliency(
        batch=CLI_BATCH, trunk="segments"), "segments")
    sals["f32_fast"] = run("f32_fast", lambda: saliency(method="fast"), "plain")
    for tag, sal in sals.items():
        check(sal, tag)

    # where the time goes: one profiled pass of the default route in f32
    # and of both kernel routes in the CLI's configuration (bf16, batch 4096)
    profiles = {f"f32_{default}_b512": device_profile(lambda: saliency(batch=512))}
    for trunk in ("segments", "stage12"):
        profiles[f"bf16_{trunk}_b{CLI_BATCH}"] = device_profile(
            lambda: saliency(batch=CLI_BATCH, dtype=bf16, trunk=trunk))
    valid = ~nodata

    def diff(a, b):
        return float(np.abs(a[valid] - b[valid]).max())
    plain = sals["f32_plain_b512"]
    diffs = {t: diff(sals[t], plain)
             for t in ("f32_segments_b512", "f32_stage12_b512", f"f32_segments_b{CLI_BATCH}")}
    bf16_plain = sals[f"bf16_plain_b{CLI_BATCH}"]
    bf16_diffs = {cli_tag: diff(cli_sal, bf16_plain),
                  f"bf16_{other}_b{CLI_BATCH}": diff(sals[f"bf16_{other}_b{CLI_BATCH}"],
                                                     bf16_plain)}
    busy = {t: profiles[f"bf16_{t}_b{CLI_BATCH}"]["device_busy_ms"]
            for t in ("segments", "stage12")}
    print(json.dumps({"exact_cnn": dict(
        strip=[STRIP_LINES, band.shape[1]], windows=n_win, default_route=default, stats=stats,
        route_vs_plain_max_abs=diffs, bf16_route_vs_bf16_plain_max_abs=bf16_diffs,
        cli_tol=CLI_TOL, cli_bf16_vs_f32_plain_max_abs=diff(cli_sal, plain),
        fast_vs_exact_max_abs=diff(sals["f32_fast"], plain),
        saliency=dict(min=float(plain[valid].min()), max=float(plain[valid].max()),
                      std=float(plain[valid].std())),
        bf16_device_busy_ms=busy, profile=profiles)}))
    seg, s12 = profiles[f"bf16_segments_b{CLI_BATCH}"], profiles[f"bf16_stage12_b{CLI_BATCH}"]
    if not seg["families_ms"].get("conv_wgmma_kernel"):
        fail(f"the segments route's bf16 profile names no tensor-core conv kernel: {seg['top']}")
    if not s12["families_ms"].get("front_kernel") or s12["families_ms"].get("cudnn_conv"):
        fail(f"the stage12 route's bf16 profile must name the front kernel and no cuDNN "
             f"convolution: {s12['families_ms']}")
    if not busy[default] <= busy[other]:
        fail(f"the default route {default} is busier on the device than {other} at bf16, "
             f"batch {CLI_BATCH}: {busy}")
    for t, d in diffs.items():
        if not d <= ROUTE_TOL:
            fail(f"{t} differs from the plain route by {d:.3g} > {ROUTE_TOL:g}")
    for t, d in bf16_diffs.items():
        if not d <= CLI_TOL:
            fail(f"{t} differs from the bf16 plain route at batch {CLI_BATCH} by "
                 f"{d:.3g} > {CLI_TOL:g}")
    return {k: (kernel_run(k, default), stats[kernel_run(k, default)]["launches"][k])
            for k in TRUNK_KERNELS}


def _timed(stats, tag, fn):
    """``fn()`` with its seconds and peak device memory into ``stats[tag]``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    stats[tag] = dict(s=time.time() - t0, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return out


def _jax_test_weights(workdir):
    """GoogLeNet weights of the kind the JAX package's dilated and bf16
    bounds were set for (tests/test_detect.py::_trained_like): init-time
    convs and fc (trunc-normal std 0.01), BatchNorm affine and running
    stats perturbed (mean N(0, 0.5), var |N(1, 0.3)|, bias N(0, 0.3),
    scale |N(1, 0.2)|); torch.Generator seed 3."""
    import torch
    from torch import nn
    from srcfinder_torch.models.convert import save_weights, torch_state_dict_to_flax
    from srcfinder_torch.models.googlenet import GoogLeNet
    gen = torch.Generator().manual_seed(3)
    model = GoogLeNet(num_classes=2, generator=gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.5, generator=gen)
                mod.running_var.normal_(1.0, 0.3, generator=gen).abs_()
                mod.bias.normal_(0.0, 0.3, generator=gen)
                mod.weight.normal_(1.0, 0.2, generator=gen).abs_()
    wf = os.path.join(workdir, "googlenet_jax_test_like.npz")
    save_weights(wf, torch_state_dict_to_flax(model.state_dict()))
    return wf


def phase_fcn_paths(workdir, cmf_product, cnn_weights):
    """The FCN's other paths on the scene's CMF band (phase 7)."""
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect import fcn_pipeline as tfp
    from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4

    band = torch.tensor(np.asarray(open_envi(cmf_product).read_band(-1), np.float32),
                        device="cuda")
    mean, std = norm_for_model("multi_64")
    x = preprocess_ch4(band, mean, std)
    x16 = preprocess_ch4(band.to(torch.bfloat16), mean, std)
    grid = x[:band.shape[0] // 32 * 32]
    model = tfp.load_saliency_model(cnn_weights, device="cuda")
    model16 = tfp.load_saliency_model(cnn_weights, dtype=torch.bfloat16, device="cuda")
    stats = {}
    phase = _timed(stats, "phase_f32", lambda: tfp.fcn_phase_saliency(model, x))
    unblocked = _timed(stats, f"phase_f32_{grid.shape[0]}",
                       lambda: tfp.fcn_phase_saliency(model, grid))
    blocked = _timed(stats, f"blocked_928_{grid.shape[0]}",
                     lambda: tfp.fcn_phase_saliency_blocked(model, grid, block=928))
    bf16 = _timed(stats, "phase_bf16", lambda: tfp.fcn_phase_saliency(model16, x16))
    batch = _timed(stats, "batch_2", lambda: tfp.fcn_phase_saliency_batch(
        model, torch.stack([x, x])))
    scan = _timed(stats, "scan_f32", lambda: tfp.fcn_phase_saliency(model, x, layout="scan"))
    dilated = _timed(stats, "dilated_f32", lambda: tfp.fcn_dilated_saliency(model, x))
    dilated16 = _timed(stats, "dilated_bf16", lambda: tfp.fcn_dilated_saliency(model16, x16))
    gap = (dilated - phase).abs()
    h, w = gap.shape
    rows, cols = torch.arange(h, device=gap.device), torch.arange(w, device=gap.device)
    edge = torch.minimum(torch.minimum(rows, h - 1 - rows)[:, None],
                         torch.minimum(cols, w - 1 - cols)[None, :])
    by_margin = {m: gap[edge >= m].max().item() for m in EDGE_MARGINS}
    worst = divmod(gap.argmax().item(), w)
    # the largest scene the dilated path admits at this width, held to the card
    lines = max(n for n in range(h, 2 * h)
                if tfp._canvas_px(n, w, 32) <= tfp.MAX_DILATED_CANVAS_PX)
    big = torch.cat([x, x[:lines - h]])
    torch.cuda.empty_cache()
    big_sal = _timed(stats, f"dilated_f32_{lines}",
                     lambda: tfp.fcn_dilated_saliency(model, big))
    del big
    jmodel = tfp.load_saliency_model(_jax_test_weights(workdir), device="cuda")
    jphase = tfp.fcn_phase_saliency(jmodel, x)
    jdilated = _timed(stats, "dilated_f32_jax_test_weights",
                      lambda: tfp.fcn_dilated_saliency(jmodel, x))

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()
    # seconds per canvas pixel at the ceiling over those of the full band
    slowdown = (stats[f"dilated_f32_{lines}"]["s"] / tfp._canvas_px(lines, w, 32)) / (
        stats["dilated_f32"]["s"] / tfp._canvas_px(h, w, 32))
    checks = {
        "blocked_vs_unblocked": (diff(blocked, unblocked), PATH_TOL),
        "bf16_vs_f32": (diff(bf16, phase), BF16_TOL),
        "batch_vs_single": (max(diff(batch[0], phase), diff(batch[1], phase)), PATH_TOL),
        "scan_vs_wide": (diff(scan, phase), PATH_TOL),
        "dilated_vs_phase_interior": (by_margin[DILATED_REACH], PATH_TOL),
        "dilated_bf16_vs_f32": (diff(dilated16, dilated), BF16_TOL),
        "dilated_vs_phase_jax_test_weights": (diff(jdilated, jphase), BF16_TOL)}
    saliency_std = {"trained_like": phase.std().item(), "jax_test_weights": jphase.std().item()}
    print(json.dumps({"fcn_paths": dict(
        band=list(band.shape), stats=stats,
        max_abs_diff={k: {"diff": d, "bound": t} for k, (d, t) in checks.items()},
        dilated_vs_phase=dict(max_abs_diff_past_edge_margin=by_margin,
                              worst_row_col=list(worst), interior_margin=DILATED_REACH),
        dilated_ceiling=dict(lines=lines, canvas_px=tfp._canvas_px(lines, w, 32),
                             ceiling_px=tfp.MAX_DILATED_CANVAS_PX,
                             slowdown_per_canvas_px=slowdown),
        saliency_std=saliency_std)}))
    for k, (d, t) in checks.items():
        if not d <= t:
            fail(f"fcn_paths {k}: max |diff| {d:.3g} > {t:g}")
    for k, v in saliency_std.items():
        if not v > 1e-3:
            fail(f"fcn_paths: the {k} saliency is near constant (std {v:.3g})")
    peak = stats[f"dilated_f32_{lines}"]["peak_mem_bytes"]
    if not peak < CARD_BYTES:
        fail(f"fcn_paths: the dilated pass at its ceiling ({lines} lines) peaked "
             f"at {peak / 1e9:.1f} GB")
    if not slowdown < DILATED_SLOWDOWN:
        fail(f"fcn_paths: the dilated pass at its ceiling ({lines} lines) is "
             f"{slowdown:.1f}x slower per canvas pixel than at {h} lines")
    for name, sal in (("blocked", blocked), ("bf16", bf16), ("batch", batch),
                      ("scan", scan), ("dilated", dilated), ("dilated_bf16", dilated16),
                      (f"dilated_{lines}", big_sal)):
        if not torch.isfinite(sal).all():
            fail(f"fcn_paths {name}: saliency not finite")


def write_long_scene(workdir, gen):
    """Seeded real-length radiance (LONG_SCENE, BIL f32) with a plume in the
    CH4 window, nodata pixels and one patch for each spectrometer mask
    class, at the bands the header's wavelengths resolve to. The 1945-2485
    nm window (the saturation test's) is scaled by 0.6, which keeps the
    background below the 6.0 threshold (unscaled, ~14% of pixels would
    saturate and the 49-pixel flare growth would take minutes)."""
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import create_envi
    nl, ns, nb = LONG_SCENE
    wl = np.linspace(380, 2500, nb)
    meta = {"lines": nl, "samples": ns, "bands": nb, "interleave": "bil",
            "data type": 4, "byte order": 0, "header offset": 0,
            "data ignore value": -9999,
            "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1",
                         "3.1", "11", "North", "WGS-84", "units=Meters",
                         "rotation=0"],
            "wavelength": [f"{w:.2f}" for w in wl]}

    def band(nm):
        return int(np.argmin(np.abs(wl - nm)))
    window = slice(band(1945.0), band(2485.0) + 1)
    sat = slice(window.start, 350)             # saturation bands outside the CMF's
    patches = [  # (rows, cols, bands, value)
        (slice(1000, 1008), slice(100, 108), sat, 8.0),                  # saturated
        (slice(3000, 3006), slice(400, 406), sat, 8.0),                  # specular:
        (slice(3000, 3006), slice(400, 406), band(505.0), 12.0),         # + glint
        (slice(8000, 8010), slice(200, 210), band(450.0), 20.0),         # cloud
        (slice(8000, 8010), slice(200, 210), band(670.0), 10.0),
        (slice(8000, 8010), slice(200, 210), band(1250.0), 5.0),
        (slice(10000, 10006), slice(500, 506), band(2139.0), 0.05)]      # dark
    rdn = os.path.join(workdir, "ang20200924t220000_rdn_v2y1_img")
    img = create_envi(rdn + ".hdr", meta)
    mm = img.open_memmap(interleave="source", writable=True)   # (L, bands, S)
    absorb = torch.ones(nb, device="cuda")
    absorb[360:410] = 0.9
    for r0 in range(0, nl, 256):
        r1 = min(nl, r0 + 256)
        blk = (torch.randn(r1 - r0, ns, nb, generator=gen, device="cuda")
               * 0.5 + 4.0).abs_().add_(0.5)
        blk[..., window] *= 0.6
        lo, hi = max(r0, LONG_PLUME[0].start), min(r1, LONG_PLUME[0].stop)
        if lo < hi:
            blk[lo - r0:hi - r0, LONG_PLUME[1]] *= absorb
        for rows, cols, b, v in patches:
            lo, hi = max(r0, rows.start), min(r1, rows.stop)
            if lo < hi:
                blk[lo - r0:hi - r0, cols, b] = v
        if r0 == 0:
            blk[0, :3] = -9999.0                               # nodata pixels
        mm[r0:r1] = blk.permute(0, 2, 1).cpu().numpy()
    mm.flush()
    del mm
    return rdn


def memmap_read_lines_bands(img, r0, r1, bands):
    """The port's band-subset read before the run-merged reader: a fancy
    index of the bands out of a (lines, samples, bands) view of the file's
    memmap (kept here only, to time it against its successor)."""
    import numpy as np
    bip = img.open_memmap(interleave="bip")
    return np.asarray(bip[r0:r1][:, :, [int(b) for b in bands]])


def pread_read_lines_bands(img, fd, r0, r1, bands):
    """The JAX package's buffered band-subset read: one ``pread`` per run
    of adjacent bands per line, straight into the (rows, bands, samples)
    result, returned as its (rows, samples, bands) view (kept here only,
    to time it against the port's mapped copies)."""
    import numpy as np
    bb = img.ncols * img.dtype.itemsize
    lb = img.nbands * bb
    out = np.empty((r1 - r0, len(bands), img.ncols), img.dtype)
    dest = out.view(np.uint8).reshape(r1 - r0, -1)
    i = 0
    while i < len(bands):
        j = i + 1
        while j < len(bands) and bands[j] == bands[j - 1] + 1:
            j += 1
        for li in range(r0, r1):
            row = memoryview(dest[li - r0, i * bb:j * bb])
            if os.preadv(fd, [row], img.offset + li * lb + bands[i] * bb) != len(row):
                fail(f"short pread at line {li}")
        i = j
    return out.transpose(0, 2, 1)


def reader_times(rdn, libf, step=500):
    """The masks' and CMF's requested band runs of ``rdn`` (the union the
    fused read takes: the mask tests' bands, band 0, the CH4 window and
    the RGB bands), read in blocks of ``step`` lines through three
    readers in turns: the old memmap fancy index, DirectFile with
    O_DIRECT, DirectFile with SRCFINDER_DIRECT_IO=0 (its copies out of
    the file's mapping, the port's default), and one ``pread`` per run
    per line (the JAX package's buffered path). Each read's result (the
    new readers return a transposed view) then becomes a contiguous
    (rows, samples, bands) array, the old reader's layout, and all must
    be byte-equal. Returns seconds per reader (the reads, and apart the
    conversions), bytes read and the mode each DirectFile ended in."""
    import numpy as np
    from srcfinder_torch.cmf.pipeline import active_range_for_library
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.masks.cli import flightline_mask_config
    from srcfinder_torch.masks.sds import needed_bands
    img = open_envi(rdn + ".hdr")
    params, _, _, wl = flightline_mask_config(img, rdn)
    a0, a1 = active_range_for_library(libf)
    req = sorted(set(needed_bands(wl, params).tolist()) | {0} | set(range(a0 - 1, a1))
                 | {60, 42, 24})
    imgs = {}
    prev = os.environ.get("SRCFINDER_DIRECT_IO")
    try:
        for name, flag in (("direct", "1"), ("buffered", "0")):
            os.environ["SRCFINDER_DIRECT_IO"] = flag
            imgs[name] = open_envi(rdn + ".hdr")
            imgs[name]._direct()                    # opens in the mode the flag sets
    finally:
        if prev is None:
            os.environ.pop("SRCFINDER_DIRECT_IO", None)
        else:
            os.environ["SRCFINDER_DIRECT_IO"] = prev
    fd = os.open(rdn, os.O_RDONLY)
    readers = {"memmap": lambda r0, r1: memmap_read_lines_bands(img, r0, r1, req),
               "direct": lambda r0, r1: imgs["direct"].read_lines_bands(r0, r1, req),
               "buffered": lambda r0, r1: imgs["buffered"].read_lines_bands(r0, r1, req),
               "pread": lambda r0, r1: pread_read_lines_bands(img, fd, r0, r1, req)}
    names = list(readers)
    secs = dict.fromkeys(names, 0.0)
    bip = dict.fromkeys(names, 0.0)
    for i, r0 in enumerate(range(0, img.nrows, step)):
        r1 = min(img.nrows, r0 + step)
        outs = {}
        k = i % len(names)
        for name in names[k:] + names[:k]:              # each reader first in turn
            t0 = time.perf_counter()
            out = readers[name](r0, r1)
            t1 = time.perf_counter()
            outs[name] = np.ascontiguousarray(out)
            secs[name] += t1 - t0
            bip[name] += time.perf_counter() - t1
        for name in names[1:]:
            if not (outs[name].shape == outs["memmap"].shape
                    and outs[name].tobytes() == outs["memmap"].tobytes()):
                fail(f"reader {name} differs from the memmap read at lines {r0}:{r1}")
    os.close(fd)
    return dict(seconds=secs, to_contiguous_seconds=bip, bands=len(req), runs=int(1 + np.count_nonzero(np.diff(req) > 1)),
                bytes=img.nrows * img.ncols * len(req) * img.dtype.itemsize, step=step,
                modes={n: im._direct().mode for n, im in imgs.items()},
                default_mode=open_envi(rdn + ".hdr")._direct().mode)


def phase_long_flightline(workdir, libf, wf):
    """A real-length flightline through run_flightline with the masks and
    IME (phase 8). Returns the K1/K2 checks at its chunk shape."""
    import numpy as np
    import pandas as pd
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect import fcn_pipeline as tfp
    from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4
    from srcfinder_torch.flow.pipeline_cli import run_flightline
    from srcfinder_torch.masks.cli import masks_for_flightline
    from srcfinder_torch.ops import loo, moments

    gen = torch.Generator(device="cuda").manual_seed(12000)
    t0 = time.time()
    rdn = write_long_scene(workdir, gen)
    setup_s = time.time() - t0
    free_gb = shutil.disk_usage(workdir).free / 1e9

    # what the FCN stage runs: the blocked path's calls and each window's
    # shape, seconds and peak device memory
    seen = {"blocked": 0, "windows": []}
    blocked, window = tfp.fcn_phase_saliency_blocked, tfp.fcn_phase_saliency

    def count_blocked(*a, **k):
        seen["blocked"] += 1
        return blocked(*a, **k)

    def count_window(model, img, *a, **k):
        st = {}
        out = _timed(st, "w", lambda: window(model, img, *a, **k))
        seen["windows"].append(dict(lines=img.shape[0], **st["w"]))
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    tfp.fcn_phase_saliency_blocked, tfp.fcn_phase_saliency = count_blocked, count_window
    try:
        t0 = time.time()
        prods = run_flightline(rdn, libf, wf, os.path.join(workdir, "out_long"),
                               prob_thr=0.0, do_masks=True, do_ime=True, device="cuda",
                               progress=lambda msg: print(msg, flush=True))
        torch.cuda.synchronize()
        total_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        tfp.fcn_phase_saliency_blocked, tfp.fcn_phase_saliency = blocked, window
    launches = {"masked_moments": moments.KERNEL.launches, "loo_sweep": loo.KERNEL.launches}

    nl, ns, _ = LONG_SCENE
    cmf = open_envi(prods["cmf"]).load()
    ppmm = cmf[..., 3]
    valid = ppmm != -9999.0
    plume = ppmm[LONG_PLUME].mean()
    bg, bg_sd = ppmm[valid].mean(), ppmm[valid].std()
    z = (plume - bg) / (bg_sd / np.sqrt(ppmm[LONG_PLUME].size))
    sal = open_envi(prods["saliency"]).load()[..., 0]
    sval = sal != -9999.0
    masks = open_envi(prods["masks"]).load()
    t0 = time.time()
    ref_name = masks_for_flightline(rdn + ".hdr", workdir, out_name="masks_cpu", device="cpu")
    cpu_masks_s = time.time() - t0
    ref = open_envi(os.path.join(workdir, ref_name)).load()
    positives = {name: int((masks[..., i] > 0).sum())
                 for i, name in enumerate(("cloud", "specular", "flare", "dark"))}

    # the unblocked phase pass at the pixel ceiling: its peak device memory
    ceiling = tfp.MAX_UNBLOCKED_PX // ns // 32 * 32
    x = preprocess_ch4(torch.tensor(np.asarray(ppmm[:ceiling], np.float32), device="cuda"),
                       *norm_for_model("multi_64"))
    model = tfp.load_saliency_model(wf, device="cuda")
    stats = {}
    _timed(stats, f"unblocked_{ceiling}", lambda: tfp.fcn_phase_saliency(model, x))
    del x, model

    # the fused read's readers, old and new, on the same file
    readers = reader_times(rdn, libf)

    # K1 and K2 at this flightline's chunk shape
    torch.cuda.empty_cache()
    kgen = torch.Generator(device="cuda").manual_seed(1200)
    x, m, Rw, Z, inv_glam, beta, parts = chunk_inputs(torch.float32, kgen, lines=nl)
    checks = cmf_kernel_checks("float32_L12000", x, m, Z, inv_glam, beta, parts)
    del x, m, Rw, Z, inv_glam, beta, parts
    torch.cuda.empty_cache()

    summary = dict(
        scene=list(LONG_SCENE), setup_s=setup_s, disk_free_gb_after_write=free_gb,
        run_s=total_s, stage_s=prods["timers"],
        read_masks_parts=prods.get("read+masks parts"), readers=readers,
        fcn_method="phase-blocked" if seen["blocked"] else "unblocked",
        fcn_windows=seen["windows"], peak_mem_bytes=peak, plume_z=float(z),
        plume_ppmm=float(plume), background_ppmm=float(bg), background_sd=float(bg_sd),
        n_candidates=len(pd.read_csv(prods["detections_csv"])),
        ime_rows=len(pd.read_csv(prods["ime_csv"])),
        mask_positives=positives, masks_equal_cpu=bool(np.array_equal(masks, ref)),
        cpu_masks_s=cpu_masks_s, launches=launches, pixel_ceiling=stats,
        kernels_L12000={k[0]: {f: v[f] for f in ("max_rel_err", "bit_identical", "ms",
                                                 "plain_ms", "bound_ms")}
                        for k, v in checks.items()})
    print(json.dumps({"long_flightline": summary}))
    if seen["blocked"] != 1 or [w["lines"] for w in seen["windows"]] != [5824] * 3:
        fail(f"the FCN ran {seen['blocked']} blocked passes over windows "
             f"{[w['lines'] for w in seen['windows']]}, not 3 windows of 5824 lines")
    if not peak < 80e9:
        fail(f"peak device memory {peak / 1e9:.1f} GB")
    if not z > 10:
        fail(f"long flightline: plume z = {z:.1f}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the long flightline")
    if not (np.isfinite(ppmm[valid]).all() and (ppmm[0, :3] == -9999.0).all()):
        fail("long flightline: CMF nodata stamp or finiteness")
    if not ((sal[sval] >= 0) & (sal[sval] <= 1)).all() or sval.sum() != nl * ns - 3:
        fail("long flightline: saliency outside [0, 1] or nodata stamp")
    if masks.shape != (nl, ns, 4) or not (masks[0, :3] == -9999).all():
        fail(f"masks product shape {masks.shape} or nodata stamp")
    if not all(positives.values()):
        fail(f"a mask band is empty: {positives}")
    if not np.array_equal(masks, ref):
        fail(f"the masks product differs from the CPU run on "
             f"{int((masks != ref).any(axis=-1).sum())} pixels")
    return checks


def cmf_times(tree):
    """Same-call A/B of the CMF kernels: ``python3 chip_smoke.py --cmf-times
    TREE`` times masked_moments and loo_sweep of TREE's srcfinder_torch
    (e.g. an unpacked ``git archive`` of another commit) at one chunk in
    float32 and float64 and at 8 columns in float64, on this script's
    seeded inputs (identical in every call), and prints one JSON line.
    Run it on two trees in turns within one call (old, new, new, old)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from srcfinder_torch.ops import build, loo, moments
    if not moments.__file__.startswith(tree):
        fail(f"srcfinder_torch was not imported from {tree}")
    build.build_all([moments.KERNEL, loo.KERNEL])
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = {}
    for dtype, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        x, m, Rw, Z, inv_glam, beta, parts = chunk_inputs(dtype, gen)
        sets = [(name, (x, m, Z, inv_glam, beta))]
        if dtype == torch.float64:
            sets.append(("float64_c8", c8_inputs(x, m, Z, inv_glam, beta, parts)[:5]))
        for tag, (xx, mm, zz, gg, bb) in sets:
            got, ref = moments.masked_moments(xx, mm), moments.masked_moments_ref(xx, mm)
            err1 = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))
            got, ref = loo.loo_sweep(zz, gg, bb, mm), loo.loo_sweep_ref(zz, gg, bb, mm)
            err2 = ((got[0] - ref[0]).abs().max() / ref[0].abs().max()).item()
            out[tag] = dict(
                masked_moments_ms=cuda_ms(lambda: moments.masked_moments(xx, mm), reps=20),
                loo_sweep_ms=cuda_ms(lambda: loo.loo_sweep(zz, gg, bb, mm), reps=20),
                masked_moments_rel_err=err1, loo_sweep_rel_err=err2)
        del x, m, Rw, Z, inv_glam, beta, parts, sets
        torch.cuda.empty_cache()
    print(json.dumps({"cmf_times": out, "tree": tree, "gpu": nvidia_smi_line()}))


def trunk_times(tree):
    """Same-call A/B of P2: ``python3 chip_smoke.py --trunk-times TREE``
    times fused_stage12 (contiguous windows) of TREE's srcfinder_torch in
    each of TRUNK_CONFIGS on seeded windows and weights (identical in
    every call), with its error against TREE's plain version, and prints
    one JSON line. Run it on two trees in turns within one call (old, new,
    new, old)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from srcfinder_torch.device import resolve_device
    from srcfinder_torch.ops import build, trunk_fuse as tf
    if not tf.__file__.startswith(tree):
        fail(f"srcfinder_torch was not imported from {tree}")
    resolve_device("cuda")                     # TF32 off for the plain version
    build.build_all([tf.KERNEL])
    gen = torch.Generator(device="cuda").manual_seed(612)
    out = {}
    for dname, n in TRUNK_CONFIGS:
        dtype = getattr(torch, dname)
        p = tf.pack_params("fused_stage12", seeded_params(gen, "fused_stage12", dtype))
        wins = torch.randn(n, WIN, WIN, 1, generator=gen, device="cuda").to(dtype)
        with torch.no_grad():
            got, ref = tf.fused_stage12(wins, p), tf.fused_stage12_ref(wins, p)
            rel = max_abs_diff(got, ref) / ref.float().abs().max().item()
            ms = cuda_ms(lambda: tf.fused_stage12(wins, p), reps=20)
        ops, n_in, n_out, n_w = trunk_work("fused_stage12", n, WIN)
        bound = max(ops / PEAK_FLOPS[dname],
                    (n_in + n_out + n_w) * (torch.finfo(dtype).bits // 8) / PEAK_BYTES) * 1e3
        out[f"{dname}_b{n}"] = dict(ms=ms, bound_ms=bound, share_of_bound=bound / ms,
                                    max_rel_err=rel)
        del wins, p, got, ref
        torch.cuda.empty_cache()
    print(json.dumps({"trunk_times": out, "tree": tree, "gpu": nvidia_smi_line()}))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--cmf-times":
        return cmf_times(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--trunk-times":
        return trunk_times(sys.argv[2])
    if not os.path.isdir(os.path.join(HERE, "srcfinder_torch")):
        fail("srcfinder_torch/ is not next to chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = nvidia_smi_line()
    print(smi)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}))

    from srcfinder_torch.ops import build, loo, moments, trunk_fuse
    built = (moments.KERNEL, loo.KERNEL, trunk_fuse.KERNEL)
    t0 = time.time()
    build.build_all(built)
    print(json.dumps({"build_s": time.time() - t0, "ptxas": {
        k.name: ptxas_summary(k.build_log()) for k in built}}))
    sass = {k.name: sass_mma_counts(k.lib_path()) for k in built}
    print(json.dumps({"sass_mma": sass}))
    if not sum(sum(c.values()) for c in sass["trunk"].values()):
        fail("no HMMA/HGMMA instruction in the trunk library")
    if not sass["trunk"].get("front_kernel<bf16>", {}).get("HGMMA"):
        fail("no HGMMA instruction in P2's bf16 front kernel (front_kernel<bf16>)")
    if not sass["loo"].get("loo_kernel<double>", {}).get("DMMA"):
        fail("no DMMA instruction in the f64 LOOCV kernel (loo_kernel<double>)")

    phase_conv_shapes()
    stage12_layers()
    checks = phase_kernels()

    workdir = os.path.join(HERE, "chip_smoke_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        flightline, cmf_product, rdn, libf = phase_main_path(workdir)
        launches = {k: ("run_flightline", n) for k, n in flightline.items()}
        mm_launches, mm_checks = phase_multimodal(workdir, libf, write_weights(workdir))
        checks.update(mm_checks)
        strip = write_strip(workdir, cmf_product)
        cnn_weights = write_cnn_weights(workdir)
        checks.update(phase_trunk_kernels(strip, cnn_weights))
        launches.update(phase_exact_cnn(workdir, strip, cnn_weights))
        phase_fcn_paths(workdir, cmf_product, cnn_weights)
        for f in (rdn, rdn + ".hdr"):          # bound the disk use
            os.remove(f)
        checks.update(phase_long_flightline(workdir, libf, write_weights(workdir)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    meta = {"masked_moments": ("srcfinder_torch/ops/csrc/moments.cu",
                               "ops/moments.py:104 masked_moments_pallas "
                               "(JAX package, git f6215a7)"),
            "loo_sweep": ("srcfinder_torch/ops/csrc/loo.cu",
                          "cmf/matched_filter.py:147 _loo_nll (JAX package; "
                          "XLA-fused, no Pallas kernel)"),
            "fused_stage12": ("srcfinder_torch/ops/csrc/trunk.cu",
                              "ops/trunk_fuse.py:173 fused_stage12 -> pl.pallas_call "
                              ":195 (JAX package, git be3cd8d)"),
            "trunk_s23": ("srcfinder_torch/ops/csrc/trunk.cu",
                          "ops/trunk_fuse.py:258 fused_trunk_segment('s23') -> "
                          "pl.pallas_call :284 (JAX package, git ca79403)"),
            "trunk_s3": ("srcfinder_torch/ops/csrc/trunk.cu",
                         "ops/trunk_fuse.py:258 fused_trunk_segment('s23') -> "
                         "pl.pallas_call :284 (JAX package, git ca79403): its "
                         "inception3a/3b and last pool"),
            "trunk_s45": ("srcfinder_torch/ops/csrc/trunk.cu",
                          "ops/trunk_fuse.py:258 fused_trunk_segment('s45') -> "
                          "pl.pallas_call :284 (JAX package, git ca79403)")}
    keys = ("max_abs_err", "max_rel_err", "tol", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # the kernels also report the repeat check, the CMF kernels their
    # shape, the library call's scope and (K2) the columns whose argmin
    # differs, P2 its gather form's agreement and time
    extra_keys = keys + ("shape", "library_call", "bit_identical", "argmin_other_columns",
                         "gather_equal", "gather_ms")
    # each kernel's configurations: the first is the one its path runs
    # (the flightline's f32 CMF; the CLI's bf16 batch of 4096 windows), top
    # level in the line; the others (the CMF's cond-gated f64 recompute,
    # the 12,000-line flightline's chunk, 512-window batches) nested
    trunk_configs = ("bfloat16_b4096", "float32_b512", "bfloat16_b512")
    cmf_configs = ("float32", "float64", "float64_c8", "float32_L12000", "multimodal",
                   "multimodal_float64")
    configs = {"masked_moments": cmf_configs, "loo_sweep": cmf_configs,
               **dict.fromkeys(TRUNK_KERNELS, trunk_configs)}
    kernels = []
    for kname, (src, rep) in meta.items():
        run, n = launches[kname]
        top, *others = configs[kname]
        entry = dict(name=kname, route="cuda", source=src, replaces=rep,
                     launches=n, launches_in=run, config=top)
        ks = [k for k in extra_keys if k in checks[(kname, top)]]
        entry.update({k: checks[(kname, top)][k] for k in ks})
        for c in others:
            entry[c] = {k: checks[(kname, c)][k] for k in ks}
            if c.startswith("multimodal"):
                # the launches of the multimodal run (phase 4b), from zero
                entry[c].update(launches=mm_launches[kname],
                                launches_in="run_flightline bgmodes=2")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
