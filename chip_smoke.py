#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device and the CUDA toolkit (nvcc). Phases:

1. Device and build: print the card's name and power limit, build the
   port's CUDA kernels from srcfinder_torch/ops/csrc (one nvcc each, all
   started together).
2. Kernels against their plain PyTorch versions on the card, at the
   shapes of one full-scene CMF column chunk (2801 lines x 256 columns x
   72 active bands, 201 alphas), in float32 and float64, on inputs made
   by the CMF's own steps from seeded radiance with invalid rows. Prints
   the eigensolve's time and one {"kernels": [...]} line.
3. The main path at real size: a seeded synthetic AVIRIS-NG-shaped
   flightline (2801 lines x 598 samples x 425 bands, f32 BIL, ~2.85 GB,
   written in line blocks) with a methane plume and a CH4 library,
   GoogLeNet weights from a seeded torch.Generator in the JAX package's
   .npz layout, then srcfinder_torch.flow.pipeline_cli.run_flightline with
   IME. Kernel launch counters are zeroed just before and read just
   after; every kernel must have launched. Checks the outputs (plume
   ppm*m above background, saliency in [0, 1] with nodata stamped, plume
   list and IME CSV written) and prints stage seconds and peak device
   memory.

Any failed phase exits non-zero without the result line. The last line
of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
# precision); f64 on the FP64 tensor cores (DMMA), which are full IEEE f64
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12                                # H100 SXM HBM3
TOL = {"float32": 1e-5, "float64": 1e-12}           # max |err| / max |ref|


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log):
    """nvcc's ``ptxas -v`` output -> {kernel<type>: [resource lines]}:
    registers, shared memory and spills of each compiled kernel."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)I([fd])", m.group(1))
            name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}>"
                    if k else m.group(1))
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(" : ")[-1].strip())
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


def chunk_inputs(dtype, gen):
    """Radiance-like chunk and the CMF's own intermediates for it: the
    kernels' inputs exactly as matched_filter_columns forms them."""
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod
    from srcfinder_torch.ops.moments import masked_moments_ref
    x = (torch.randn(L, C, B, generator=gen, device="cuda") * 0.5 + 4.0
         ).abs_().add_(0.5).to(dtype)
    x[::37, :, 3] = -1.0                       # invalid rows in every column
    m = mfmod.valid_mask(x).to(dtype)
    x = torch.where(m.bool()[:, :, None], x, torch.zeros((), dtype=dtype, device="cuda"))
    n, mu, S = masked_moments_ref(x, m)
    d = torch.sqrt(torch.clamp(torch.diagonal(S, dim1=1, dim2=2), min=1e-30))
    Rw = S / (d[:, :, None] * d[:, None, :])
    lam, V = torch.linalg.eigh(Rw)
    Zc = torch.bmm(((x - mu[None]) * m[:, :, None]).permute(1, 0, 2), V / d[:, :, None])
    alphas = torch.as_tensor(mfmod.default_alphas(), dtype=dtype, device="cuda")
    beta = (1.0 - alphas)[None, :] / torch.clamp(n - 1.0, min=1.0)[:, None]
    glam = (n[:, None] * beta)[:, None, :] * lam[:, :, None] + alphas[None, None, :]
    inv_glam = 1.0 / torch.where(glam > 0, glam, torch.ones_like(glam))
    # real covariances keep q = 1 - beta*r > 0 (leverage < 1); a far
    # steeper beta on 8 columns drives q far below 0 there, for every alpha
    # but alpha = 1 (beta = 0), so the q_ok flag path runs too, with no q
    # near 0 where f32 rounding could flip it
    beta[-8:] *= 1e9
    return x, m, Rw, Zc.permute(1, 0, 2), inv_glam, beta


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


def phase_kernels():
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod
    from srcfinder_torch.ops import loo, moments

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    cmf_ms = {}
    for dtype, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        x, m, Rw, Z, inv_glam, beta = chunk_inputs(dtype, gen)
        s = torch.finfo(dtype).bits // 8
        alphas = torch.as_tensor(mfmod.default_alphas(), dtype=dtype, device="cuda")
        abscf = torch.full((B,), -0.05, dtype=dtype, device="cuda")
        Zc = Z.permute(1, 0, 2)
        cmf_ms[name] = dict(
            eigh=eigh_probe(Rw, gen),
            whiten_bmm=cuda_ms(lambda: torch.bmm(Zc, Rw)),
            matched_filter_columns=cuda_ms(
                lambda: mfmod.matched_filter_columns(x, m, abscf, alphas), reps=3))

        # K1 masked moments
        got = moments.masked_moments(x, m)
        torch.cuda.synchronize()
        ref = moments.masked_moments_ref(x, m)
        err = max(((g - r).abs().max() / r.abs().max().clamp(min=1e-300)).item()
                  for g, r in zip(got, ref))
        abs_err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        xc = (x - ref[1][None]) * m[:, :, None]
        k1 = dict(
            max_abs_err=abs_err, max_rel_err=err,
            ms=cuda_ms(lambda: moments.masked_moments(x, m)),
            plain_ms=cuda_ms(lambda: moments.masked_moments_ref(x, m), reps=3),
            library_ms=cuda_ms(lambda: torch.einsum("lcb,lcd->cbd", xc, xc), reps=3),
            bytes=s * (L * C * B + L * C + C + C * B + C * B * B),
            # S is symmetric: B(B+1)/2 multiply-adds per line; the mean
            # pass and the centring add 4 operations per element, the
            # count one per line
            ops=L * C * B * (B + 1) + 4 * L * C * B + L * C)
        del xc

        # K2 LOOCV sweep
        got = loo.loo_sweep(Z, inv_glam, beta, m)
        torch.cuda.synchronize()
        ref = loo.loo_sweep_ref(Z, inv_glam, beta, m)
        if not torch.equal(got[1], ref[1]):
            fail(f"loo_sweep {name}: q_ok differs from the plain version")
        if ref[1].all() or not ref[1].any():
            fail("loo_sweep inputs do not exercise both q_ok outcomes")
        z2 = Z * Z
        k2 = dict(
            max_abs_err=(got[0] - ref[0]).abs().max().item(),
            max_rel_err=((got[0] - ref[0]).abs().max()
                         / ref[0].abs().max()).item(),
            ms=cuda_ms(lambda: loo.loo_sweep(Z, inv_glam, beta, m)),
            plain_ms=cuda_ms(lambda: loo.loo_sweep_ref(Z, inv_glam, beta, m), reps=3),
            library_ms=cuda_ms(lambda: torch.einsum("lcb,cba->lca", z2, inv_glam), reps=3),
            bytes=s * (L * C * B + C * B * A + C * A + L * C + C * A) + C * A,
            ops=2 * L * C * B * A + 7 * L * C * A)
        del z2, x, m, Rw, Z, Zc, inv_glam, beta, got, ref
        torch.cuda.empty_cache()
        for kname, k in (("masked_moments", k1), ("loo_sweep", k2)):
            if not k["max_rel_err"] <= TOL[name]:
                fail(f"{kname} {name}: relative error {k['max_rel_err']:.3g} "
                     f"> {TOL[name]:g}")
            t_bytes = k["bytes"] / PEAK_BYTES * 1e3
            t_ops = k["ops"] / PEAK_FLOPS[name] * 1e3
            k["bound_ms"] = max(t_bytes, t_ops)
            k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            k["tol"] = TOL[name]
            results[(kname, name)] = k
    print(json.dumps({"cmf_chunk_ms": cmf_ms, "chunk": [L, C, B, A]}))
    return results


def write_scene(workdir, gen):
    """Seeded AVIRIS-NG-shaped radiance (BIL f32) with a plume in the CH4
    window, written in line blocks; plus the CH4 unit-absorption library."""
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
    rdn = os.path.join(workdir, "ang20200924t211102_rdn_v2y1_img")
    img = create_envi(rdn + ".hdr", meta)
    mm = img.open_memmap(interleave="source", writable=True)   # (L, bands, S)
    absorb = torch.ones(nb, device="cuda")
    absorb[360:410] = 0.9
    for r0 in range(0, nl, 256):
        r1 = min(nl, r0 + 256)
        blk = (torch.randn(r1 - r0, ns, nb, generator=gen, device="cuda")
               * 0.5 + 4.0).abs_().add_(0.5)
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
    moments.KERNEL.launches = 0
    loo.KERNEL.launches = 0
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
    return launches


_PROFILER_MARKERS = ("Buffer Flush", "Activity Buffer Request")


def profile_stages(rdn, libf, wf, cmf_product, workdir):
    """Second, profiled pass over the same scene, one profile per device
    stage (CMF, FCN): wall time, device-busy time (sum of kernel and copy
    time), idle share and the busiest device functions."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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

    out = {}
    for name, fn in (("cmf", cmf), ("fcn", fcn)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        # device-side events only (kernels and copies), summed per name;
        # the CUPTI buffer markers are the profiler's own overhead
        by_name = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.name in _PROFILER_MARKERS:
                continue
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
        rows = sorted(((k[:90], t, n) for k, (t, n) in by_name.items()),
                      key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        out[name] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                         idle_share=1.0 - busy_ms / wall_ms,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         top=rows[:12])
    print(json.dumps({"profile": out}))


def main():
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

    from srcfinder_torch.ops import build, loo, moments
    t0 = time.time()
    build.build_all([moments.KERNEL, loo.KERNEL])
    print(json.dumps({"build_s": time.time() - t0, "ptxas": {
        k.name: ptxas_summary(k.build_log()) for k in (moments.KERNEL, loo.KERNEL)}}))

    checks = phase_kernels()

    workdir = os.path.join(HERE, "chip_smoke_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        launches = phase_main_path(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    meta = {"masked_moments": ("srcfinder_torch/ops/csrc/moments.cu",
                               "ops/moments.py:104 masked_moments_pallas "
                               "(JAX package, git f6215a7)"),
            "loo_sweep": ("srcfinder_torch/ops/csrc/loo.cu",
                          "cmf/matched_filter.py:147 _loo_nll (JAX package; "
                          "XLA-fused, no Pallas kernel)")}
    keys = ("max_abs_err", "max_rel_err", "tol", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = []
    for kname, (src, rep) in meta.items():
        # top level: float32, the main path's precision; "float64": the
        # same numbers for the cond-gated recompute's instantiation
        entry = dict(name=kname, route="cuda", source=src, replaces=rep,
                     launches=launches[kname], dtype="float32")
        entry.update({k: checks[(kname, "float32")][k] for k in keys})
        entry["float64"] = {k: checks[(kname, "float64")][k] for k in keys}
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
