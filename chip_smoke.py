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
   (front_kernel<bf16>) HGMMA, every width of the f32 conv as 3xTF32
   (conv_tf32x3_kernel<float, 16 .. 128>) HGMMA, every width of the bf16
   conv (conv_wgmma_kernel<bf16, 32 .. 256>) HGMMA, and the f64 LOOCV
   kernel (loo_kernel<double>) DMMA.
2. The convolutions one by one: every distinct conv trunk_s23 and
   trunk_s45 launch (srcfinder_torch.ops.trunk_fuse.conv_plan) in bf16 at
   the CLI's configuration (4096 windows of 256 x 256), and every distinct
   f32 conv of P2 (its conv3), trunk_s23 and trunk_s45 at the f32 API's
   batch (F32_BATCH), each in the sub-batch its segment runs, through the
   single-conv entry with the segment's channel offsets, pixel strides and
   split, against the plain conv in its dtype (TRUNK_TOL), two launches
   bit-identical, with channels outside the written ones left as they
   were; f32 rows also give the kernel's and cuDNN-f32's errors against an
   f64 conv on their first F64_WINDOWS windows. Prints ms, achieved
   TFLOP/s, the bound (f32 as 3xTF32, beside the FMA pipes' bound), the
   share of it, and the tile width the dispatch picked for each (it must
   be the tensor-core kernel's, as tensor_core_ok says, at the width
   trunk_fuse.conv_tile_width gives: one column tile wherever cout <= 256
   in bf16, <= 128 in f32; each launch counted under its dtype and width by
   trunk_fuse.conv_launches). Then
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
   dtypes. Then the batched eigensolve kernel (csrc/syevj.cu) on the
   chunk's 256 correlation matrices and on random ones, in both dtypes
   (eigh_probe: errors against float64 eigh and the plain version, sweep
   counts, repeats bit-identical, ms beside torch.linalg.eigh's and the
   plain version's). Prints the chunk's times and one {"kernels": [...]}
   line.
3a. The masks' dilation kernel (phase_morph, "morph" line;
   srcfinder_torch/ops/csrc/morph.cu, which replaces no TPU kernel) at the
   masks cell's shapes: a 554 x 598 mask block by disk(49) and a 2801 x 598
   cloud map by the r = 49 diamond, at seed densities 0 to 1, equal bit for
   bit to its plain version on the card (and to scipy at 1e-4 and 1e-2),
   two launches equal; its CUDA-event ms a call on one 4 x 4 seed and its
   kernels' device ms (torch.profiler) beside their bound,
   the plain version's ms on the card and scipy's host ms. Its launches on
   the main path are counted in phase 8's masked flightline.
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
4a. The host runtime ("native" line; it runs right after phase 4, on its
   radiance and products): srcfinder_torch/ops/csrc/native.cpp built by
   the host's c++ (seconds, compiler version), then each function against
   its plain version on the host with the host seconds of both: the BIL
   repack of the CMF's active window (72 bands) over all 598 columns from
   a read-only memmap of the radiance, bit-equal to the numpy slice,
   transpose and cast; label8 of the masks the salience stage labels
   (saliency > the run's prob_thr 0, ppm*m > 250) and of a seeded 12,000 x
   598 mask at density 0.5, id for id against imlabel; LZW encode and
   decode of a 256 x 256 x 4 f32 tile and of the 2801 x 598 CMF band,
   bytes equal to the pure-Python codec's and round-tripping.
4b. The multimodal CMF ("multimodal" line): the same recipe with two
   background modes (the first half of the lines raised by MODE_OFFSET),
   through run_flightline(bgmodes=2) with IME, its K1/K2 launches counted
   from zero (with the eigensolve's launches and f64-gated columns, per
   chunk); then
   srcfinder_torch.cmf.cli -k 3 -r -f -m in a process of its own, and the
   bgmodes=2 CMF in float64 on the card with its labels. The labels must
   find the two modes (agreement > LABEL_AGREEMENT up to a swap in every
   column), the f32 map lie within MM_F32_TOL of the f64 map's maximum and
   the plume's z exceed 10; K1 and K2 at the run's mode-1 masks of its
   padded last chunk (modes empty in the padded columns) with beta from
   the full column's count, in f32 and f64, against their plain versions
   (TOL, the argmin check, repeats bit-identical). Prints seconds per
   stage and peak device memory; the scene is deleted after.
4c. The emission stage ("winds" line): the main path's radiance in a
   watched directory, seeded f64 .npz wind grids at the real cell counts
   (HRRR 1059 x 1799 with 10 m and 80 m winds, RTMA 1377 x 2145, 3 files
   each, regular lat/lon around the scene; ~0.7 GB, deleted after), and
   srcfinder_torch.flow.pipeline_cli.main with --watch --once --ime
   --winds --wind-ext .npz in this process: watcher, job queue, CMF (K1
   and K2 counted from zero), FCN with the trained-like weights of phase 5,
   salience, IME, the IME merge and msf-flow. The salience threshold is
   the CLI's 0.5 where that gives WIND_CANDIDATES candidates with one in
   the plume, else the highest quantile of the saliency that does. Every
   selection of nearest cells equals a host f64 oracle's (numpy spherical
   cosines, stable argsort; ties within WIND_TIE_KM compared as sets),
   every wind mean and std the oracle's over the same files (rtol 1e-12),
   every emission rate AvgIMEdivFetch20 x mean x 3600 (rtol 1e-12). Prints
   candidates, grid reads, stage seconds, the device ms of one nearest-
   cell search at each grid size (CUDA events, median of 10) beside the
   whole call's and the oracle's host ms, and peak device memory.
4d. Detection post-processing (phase_postproc, "postproc" line; it runs
   right after phase 4) on the main path's 2801 x 598 CMF ppm*m band:
   filtdet at the reference constants (k = 50) on the card and on the CPU
   (the KDE within POST_TOL of its maximum, detkde within POST_TOL of it
   over mfmax - mfmin, the components equal), gaussian_downsample from the scene's 3.1 m to 30 m
   on both (within POST_TOL of the maximum, nodata cells equal), then
   srcfinder_torch.detect.downsample_cli.main once on the card; ms of each.
4e. The trainer (phase_train, "train" line; it runs after 4d) at
   srcfinder-train's full width: a seeded campaign of 64 uncompressed
   256 x 256 x 4 GeoTIFF tiles (CH4 in band 4, plume blobs on the positives; train.csv 48,
   test.csv 16) and one LZW tile read and written on its own (the native
   codec, timed); srcfinder_torch.train.cli.main in this process
   (GoogLeNet-1ch with aux heads, crop 256, batch 16, SAM, 2 epochs,
   CalCH4_v8), its hand-kernel counters zeroed just before and read just
   after (none is on this path); finite losses, the CSVs, metrics.json, no
   npz before the 5th epoch, the final npz reloading bit-equal; a one-epoch
   --resume from it at epoch 4 of 5 with augC writes the 5-epoch npz. One
   SAM step on the card against the same step on the CPU (same weights
   and batch, dropout 0, aux_weight 0 and 0.3), per tensor (relative L2:
   parameters, running statistics, momentum) within TRAIN_TOL or no
   farther from the card's f64 step than TRAIN_RATIO times the CPU's, the
   loss within TRAIN_TOL. Prints
   the SAM and SGD step ms at batch 16 (median of 12 after 3, CUDA
   events, and the host's ms to queue each step), images/s, each epoch's host data seconds against its device
   step seconds (augA, augC), the device's idle share over one epoch of
   the loop (torch.profiler), peak device memory.
4f. The msf-flow stages ("flow_stages" line; it runs after 4c): the
   deployment's own job map (deployment/jobs.json) through
   python -m srcfinder_torch jobs, each job a process of the port's
   dispatcher, with every import traced (PYTHONPROFILEIMPORTTIME): a seeded
   season of a basin-wide AVIRIS-NG campaign over the Permian (FLOW_*:
   4,096 plumes around ~1,000 sources, 120 flightline polygons in a
   .shp/.dbf) through cluster-incr-nn -> filter-plumes ->
   source-persistence, one stage per watched directory (FLOW_STAGES);
   inversion-run on a TROPOMI-style inversion of 1,024 cells from 16,384
   retrievals (INV_*; trop_H.csv 16,384 x 1,024) on the card; and
   wind-quality-check and wind-bands-nc on phase 4c's HRRR 1059 x 1799
   grid (written again here); then python -m srcfinder_torch windspeed on
   the card over those grids. Every job must succeed and no process may
   import jax or the JAX package; the clusters must match the sources
   with plumes within 2%, every persistence source have FLOW_DAYS
   overflights, every emission rate equal AvgIMEdivFetch20 x mean x 3600.
   The inversion job's x_hat and S_hat must equal direct calls of the
   port's functions on the card bit for bit, and lie within INV_TOL of the
   port's f64 solve on the card. Prints seconds per job with its imports
   (torch's apart), the inversion's device ms per function (CUDA events)
   in f32 and f64 beside its operations and its bound at the f32 rate,
   cond(K), the S_hat csv write's host seconds, the peak device memory.
   The path launches no hand kernel: its device work is cuSOLVER and
   cuBLAS through torch.linalg, and the nearest-cell search.
4g. CMF systematics triage and QC labelling ("triage_qc" line; it runs
   after 4f), every console script a process of python -m srcfinder_torch
   with every import traced, the hand kernels' counters zeroed before and
   read after (none is on this path). (a) covid-oracle at the reference's
   size (TQ_*): 280 curated flightlines (120 / 40 / 60 / 60 of severity
   0 / 0.5 / 1 / 2; severity >= 1 and every other 0.5 with column spikes),
   272 robust column-stats CSVs of 598 columns (half in the _clip
   spelling) and 8 CMF products of 12,000 x 598 x 4 f32 (~0.92 GB, deleted
   after) to profile again; run on the card (the CLI's default) and with
   --device cpu into a stats directory of its own: the printouts equal,
   the regenerated CSVs npix exactly and the rest within TQ_STATS_RTOL,
   every severity-2 flightline flagged; again on the card with --expected
   set to the CPU's printout (exit 0, ALL COUNTS MATCH) and with one count
   changed (exit 1). Prints the reads, column_stats' device ms on one
   12,000 x 598 band (CUDA events, median of 10) beside the CPU's, each
   process's seconds and imports (torch's apart). (b) one labelling season:
   3 users, 6 CMF products at the main path's scene size with saliency and
   label-image siblings, 8 campaign candidates each as every user's
   starting autosave; each user's tagger at its user_port (the first two
   with --precache on one cache, the second rewriting nothing) driven over
   HTTP through info, bounds, flags, the fitted and a zoomed /img with all
   five layers (decoded, sizes checked), seeded relabels, an add by click
   offsets (within 1 px of click_to_pixel's pixel), a delete, flags and
   submit; then collect-qc --auto-resolve m, whose candidate labels must
   equal consensus_rules (written apart from the port's) over the seeded
   table, which reaches every rule, a flightline rejected by a flag and a
   conflict resolved to ambiguous. The tagger and collect-qc import no
   torch. Prints start seconds, the median ms per endpoint, /img ms fitted
   and zoomed, the precache's and collect-qc's seconds, and the precache
   of the 6 products in this process in turns by precache_gtifs' threads
   and by 4 spawned processes (the seconds of each run).
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
   bound (f32 rows: as 3xTF32 on the tensor cores, the way their convs
   run, and at the FMA pipes' rate as bound_fma_ms). fused_stage12's
   gather form, reading the windows from the padded strip, must equal the
   contiguous form bit for bit, and two launches of
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
   each margin from the edges; the dilated pass in bf16; the dilated pass
   in line windows (DILATED_WINDOWS windows of block DILATED_BLOCK on the
   band's 2,880-line canvas, the real 448-line halo) against the one pass,
   in f32 within PATH_TOL and in bf16 within BF16_TOL; the dilated pass
   against the phase pass within BF16_TOL over the whole map with the
   weights the JAX package's bound holds for (init-time convs, BatchNorm
   perturbed). Returns the one-pass f32 dilated pass's seconds per canvas
   pixel.
8. A real-length flightline: a seeded 12,000 x 598 x 425 f32 BIL radiance
   (12.2 GB; the 2801-line radiance is deleted first) with a methane
   plume, nodata pixels, and a saturated, a specular, a cloud and a dark
   patch, through run_flightline with the masks and IME at the defaults
   (prob_thr 0 as in phase 4): the fused cmf+masks single read, then the
   FCN through the halo-blocked path (3 windows of 5,824 lines). Checks
   the plume's z, the route and windows, that each mask band is
   non-empty and equal to masks_for_flightline on the CPU over the same
   file, that K1/K2 launched, that the dilation kernel launched once for
   each dilation the CPU run made (by element, none zero: the flare's
   mask blocks by disk, the cloud buffer by diamond),
   fcn_saliency_image(method="dilated") on the CMF band (its default
   windows: 5 of 3,328 canvas lines), with the run's weights against
   the run's saliency and with the trained-like weights against the
   blocked phase pass with them, each within PATH_TOL at
   DILATED_REACH from every edge, nodata stamped alike, each window's
   peak under the card's memory, its seconds per canvas pixel within
   DILATED_SLOWDOWN of phase 7's one pass (windows, seconds and peaks
   printed), and K1/K2 at this chunk shape (12,000 x 256
   x 72, f32) against their plain versions (TOL, repeats bit-identical);
   prints stage seconds, the fused read+masks phase by part (the seconds
   of its masks.* spans summed by name: disk reads and slab taps in the
   reader thread; pixel tests, growth, buffer and write in the main
   one), peak device memory, the windows' peaks, and
   the unblocked phase pass's peak at the pixel ceiling (8,352 lines).
   Then times the fused read's band runs of the file through the old
   memmap fancy index, the port's DirectFile (its copies out of the
   file's mapping) and one pread per run per line (the JAX package's
   buffered path; it and the memmap index are kept here only), in turns
   per 500-line block, byte-equal ("readers").

9. Multi-GPU ("multigpu" line; it runs after phase 7, on the main path's
   scene): a mesh of every card where there are two or more, else
   MG_SHARDS_ONE_CARD shards on card 0 (which proves the sharding and the
   gather, not a speed-up; the line says which). shard_columns_mf over the
   scene's active cube in its three 256-column chunks (f32, 201 alphas)
   against the single-device call (mf within TOL of its maximum, every
   column's alpha the same or its nll minimum within TOL), K1 and K2
   launched shards x chunks times from zero; the first chunk with two
   background modes (bgmodes=2): labels equal to the single call's.
   fcn_phase_saliency(mesh=) on the CMF band with the trained-like weights
   within PATH_TOL of the single call; cnn_window_saliency_sharded on the
   strip at the CLI's configuration (bf16, batch 4096, stage12) equal bit
   for bit to the single call, P2, s3 and s45 counted from zero, with one
   batch's host queue ms beside its device ms and the same batch on every
   shard at once (each thread's start and end). Seconds of each sharded
   call beside the single call's (both warmed up first) and each card's
   peak memory.
   Then MG_RANKS data-parallel ranks of the trainer (NCCL, one card each,
   where there are two or more cards; else gloo, both on card 0): one f64
   SAM step (dropout 0) on phase 4e's first global batch of 16 held to the
   one-process f64 step (MG_DP_TOL per tensor, the loss within
   MG_LOSS_ATOL); each rank's f32 SAM step ms (CUDA events) and host ms
   with its reductions and, on the same rows, without them (the share the
   data-parallel step adds), one all-reduce's device us at 8 KB and 28 MB,
   and rank 0's host ops with the most self time in a data-parallel step
   (torch.profiler); then
   srcfinder_torch.train.cli.main --devices MG_RANKS for one epoch of the
   campaign, each file written once. The backend that ran is printed and
   must be NCCL on two or more cards.

Any failed phase exits non-zero without the result line. The last line
of standard output is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cmf-times TREE
    python3 chip_smoke.py --trunk-times TREE

only time the CMF kernels (on phase 3's inputs; see cmf_times) or the
trunk kernels (P2, s23, s3 and s45 in each of TRUNK_CONFIGS, on seeded
windows and maps; see trunk_times), of TREE's srcfinder_torch, for a
same-call A/B of two commits.

    python3 chip_smoke.py --train-times TREE
    python3 chip_smoke.py --multigpu

time the one-card SAM step of TREE's srcfinder_torch (see train_times;
old, new, new, old in one call), and run phase 9 alone (after the build,
on the main path's scene), with no result line.
"""

from __future__ import annotations

import csv
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
# TF32 on the tensor cores (dense): f32-accurate work as 3xTF32 costs
# three TF32 products for each f32 one
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12                                # H100 SXM HBM3


def trunk_bound(ops, nbytes, dname):
    """Bound of trunk work of ``ops`` operations moving ``nbytes``: {bound_ms,
    bound_by}, the larger of the bytes over PEAK_BYTES and the operations
    at the rate of the tensor cores that run them: bf16 at its own, f32 as
    3xTF32 (three TF32 products for each f32 one, as the f32 convs run);
    f32 work also gets bound_fma_ms, at the FMA pipes' rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (3 * ops / PEAK_TF32 if dname == "float32" else ops / PEAK_FLOPS[dname]) * 1e3
    out = dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    if dname == "float32":
        out["bound_fma_ms"] = max(t_bytes, ops / PEAK_FLOPS[dname] * 1e3)
    return out
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
# cnn_saliency_image's default batch, in its default dtype (float32)
F32_BATCH = 512
# windows of each f32 conv shape also held against the conv in f64
F64_WINDOWS = 16
# the trunk kernels each route launches
ROUTE_KERNELS = {"segments": ("trunk_s23", "trunk_s45"),
                 "stage12": ("fused_stage12", "trunk_s3", "trunk_s45"), "plain": ()}
# each trunk entry point's input side, as the routes call them on WIN windows
TRUNK_SIDES = {"fused_stage12": WIN, "trunk_s23": WIN // 2, "trunk_s3": WIN // 8,
               "trunk_s45": WIN // 16}
# P2's side of each 3-window check: 40 leaves ragged 8 x 8 front tiles
STAGE12_SMALL = (40, 64, 256)


def plan_conv_launches(counts, dtype):
    """{tile width: conv launches} in ``dtype`` that the trunk entry-point
    calls ``counts`` ({entry point: calls}) make on WIN windows: each call
    launches every conv of its conv_plan once, at the width
    trunk_fuse.conv_tile_width gives."""
    from srcfinder_torch.ops import trunk_fuse as tf
    want = {}
    for k, n in counts.items():
        if not n:
            continue
        for c in tf.conv_plan(k, TRUNK_SIDES[k]):
            w = tf.conv_tile_width(c.cout, dtype)
            want[w] = want.get(w, 0) + n
    return want


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
# the windowed dilated pass (phases 7 and 8): its seconds per canvas pixel
# within DILATED_SLOWDOWN of the one-pass 2801-line pass's; phase 7 forces
# blocks of DILATED_BLOCK canvas lines, DILATED_WINDOWS windows of the
# band's 2,880-line canvas (928, the blocked phase path's block over 2,784
# image lines, would take 4 here)
DILATED_SLOWDOWN = 3.0
DILATED_BLOCK, DILATED_WINDOWS = 960, 3
# the two-mode scene (phase 4b): the first half of the lines raised in every
# band by the offset of tests/test_cmf_pipeline.py:259; k-means must find
# the two halves (label agreement up to a swap) in every column; the f32
# map's bound against the f64 one is that test's (of the f64 map's maximum)
MODE_OFFSET = 8.0
LABEL_AGREEMENT = 0.99
MM_F32_TOL = 5e-3
# the emission stage (phase 4c): wind grids at the real CONUS cell counts
# (HRRR 1059 x 1799 at ~3 km with 10 m and 80 m winds, RTMA 1377 x 2145 at
# ~2.5 km), regular in lat/lon and centred on the scene (UTM 11N 272247 E,
# 3992010 N); their file times bracket the scene id's 2020-09-24 21:11:02
WIND_CENTER = (36.04, -119.5)
WIND_GRIDS = {"hrrr": ((1059, 1799), (0.027, 0.0334),
                       [f"hrrr.20200924{h}.wrfsfcf00.npz" for h in (20, 21, 22)]),
              "rtma": ((1377, 2145), (0.0225, 0.0278),
                       [f"rtma2p5_ru.20200924{hm}z.2dvaranl_ndfd.npz"
                        for hm in ("2100", "2115", "2130")])}
WIND_K = 10                        # nearest cells per file (compute_wind_stats)
# candidates of the winds run: at least 10, and few enough that its 9 grid
# reads per candidate keep the phase near two minutes
WIND_CANDIDATES = (10, 25)
WIND_TIE_KM = 1e-9                 # oracle distances this close are a tie
# the real-length flightline (phase 8): 12,000 lines, on the 32-line grid
LONG_SCENE = (12000, 598, 425)
LONG_PLUME = (slice(6000, 6040), slice(290, 310))
# the msf-flow stages (phase 4f). A season of a basin-wide AVIRIS-NG campaign
# over the Permian: FLOW_STRIPS north-south flightline strips of FLOW_SWATH
# degrees (~2.8 km, 598 samples at ~4.7 m) across FLOW_BOX, each flown on
# FLOW_DAYS days (120 flightlines), FLOW_SOURCES point sources in the swaths
# and FLOW_PLUMES plume candidates ~20 m around them (several in one line:
# what the dedup stage removes). A TROPOMI-style inversion: INV_GRID state
# cells of INV_CELL degrees (the GEOS-Chem nested grid's) from INV_OBS
# retrievals of about a week, each seeing the cells within FOOT_CELLS of it.
FLOW_PLUMES, FLOW_SOURCES = 4096, 1024
FLOW_STRIPS, FLOW_DAYS, FLOW_SWATH = 30, 4, 0.03
FLOW_BOX = ((31.0, 33.0), (-104.0, -101.5))                  # lat, lon
INV_GRID, INV_CELL, INV_ORIGIN = (32, 32), (0.25, 0.3125), (27.0, -108.0)
INV_OBS, FOOT_CELLS = 16384, 3.0
# the card's f32 inversion against its f64 one, max |err| / max |f64|:
# Cholesky and LU in f32 lose about cond(K) x 2^-24 of the residual
# solve (cond(K) ~1e4 here), smoothed by S_a H^T
INV_TOL = 1e-3
# the deployment's job map in stages: each stage watches its own directory
# (the previous stage's OUTFILE lands in the next one's), since the map's
# jobs share one OUTFILE parameter
FLOW_STAGES = (("cluster-incr-nn", "inversion-run"), ("filter-plumes",),
               ("source-persistence",), ("wind-quality-check", "wind-bands-nc"))
# CMF systematics triage and QC labelling (phase 4g). The COVID oracle at the
# reference's size: 280 curated flightlines (COVID_systematics.txt), 120 of
# severity 0 (the reference's strict no-systematics TP + FP, 98 + 22) and
# 40 / 60 / 60 of 0.5 / 1 / 2; a robust column-stats CSV of ANG_NCOLS
# columns for all but TQ_REGEN of them, whose CMF products (real flightline
# length, 4 bands, f32) are profiled again. Severity >= 1, and every other
# 0.5, carries column spikes in its median profile.
TQ_SEVERITIES = ((0.0, 120), (0.5, 40), (1.0, 60), (2.0, 60))
TQ_REGEN, TQ_CMF_LINES = 8, 12000
TQ_STATS_RTOL = 1e-6
# one labelling season on the tagger: TQ_USERS, TQ_FLIGHTLINES CMF products
# of the main path's scene size, TQ_CANDIDATES campaign candidates each
TQ_USERS = ("alice", "bob", "carol")
TQ_FLIGHTLINES, TQ_CANDIDATES = 6, 8
TQ_LIDFILTERS = {"Coverage": {"accept": ["good", "partial"], "reject": ["bad"]},
                 "Clouds": {"accept": ["none", "some"], "reject": ["many"]},
                 "Artifacts": {"accept": ["none", "some"], "reject": ["severe"]}}


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_label(mangled):
    """``name<type, ints>`` of a mangled ``*_kernel`` template instance."""
    # <length><name> in the mangled name: the first whose length matches
    k = next((m for m in re.finditer(r"(?=(\d{1,2})([a-z][a-z0-9_]*?_kernel)I(\w+))", mangled)
              if int(m.group(1)) == len(m.group(2))), None)
    if not k:
        return mangled
    args = k.group(3)
    # the element type: a template argument, or else Conv<T> among the
    # parameters (conv_tf32x3_kernel<TBN>(Conv<float>))
    c = re.match(r"[fd]", args) or re.search(r"I([fd])E", args)
    t = ["bf16"] if "bfloat16" in args else (
        [{"f": "float", "d": "double"}[c.group(c.lastindex or 0)]] if c else [])
    return f"{k.group(2)}<{', '.join(t + re.findall(r'L[ib](\d+)E', args))}>"


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
    """The batched eigensolve kernel (ops/eigh.py + csrc/syevj.cu) over one
    chunk's 256 correlation matrices, on the CMF's own matrices and on
    random correlation matrices with a spread spectrum: its ms a call
    beside torch.linalg.eigh's (cuSOLVER's batched Jacobi, the yardstick
    ``library_ms``, with its device kernels a matrix) and the plain
    version's (``plain_ms``), its bound (9 B^3 operations a matrix at the
    dtype's peak, or its bytes in and out), its sweep counts and the
    launches the probe made.
    Its eigenvalues must lie within B eps ||M|| of float64 eigh's and of
    the plain version's, V diag(lam) V^T within B eps ||M|| of M, V^T V
    within B eps of I, and two launches must be bit-identical. Returns
    the line's dict."""
    import collections
    import torch
    from srcfinder_torch.ops import eigh
    Cn, Bn, _ = Rw.shape
    dname = "float64" if Rw.dtype == torch.float64 else "float32"
    eps = torch.finfo(Rw.dtype).eps
    A = torch.randn(Cn, Bn, Bn, generator=gen, device="cuda", dtype=Rw.dtype)
    S = A @ A.transpose(1, 2) + 1e-2 * torch.eye(Bn, device="cuda", dtype=Rw.dtype)
    dd = torch.sqrt(torch.diagonal(S, dim1=1, dim2=2))
    Rr = S / (dd[:, :, None] * dd[:, None, :])
    eye = torch.eye(Bn, device="cuda", dtype=torch.float64)
    out = {}
    for tag, M in (("cmf", Rw.contiguous()), ("random", Rr.contiguous())):
        eigh.reset()
        lam, V, sweeps = eigh.syevj(M)
        torch.cuda.synchronize()
        lr, _, sr = eigh.syevj_ref(M)
        M64 = M.double()
        l64 = torch.linalg.eigvalsh(M64)
        norm = torch.linalg.matrix_norm(M64, ord=2)[:, None]
        err = dict(
            lam_vs_f64=((lam.double() - l64).abs() / norm).max().item(),
            lam_vs_plain=((lam.double() - lr.double()).abs() / norm).max().item(),
            reconstruction=((V.double() @ torch.diag_embed(lam.double()) @ V.double().mT
                             - M64).abs().amax(dim=2) / norm).max().item(),
            orthogonality=(V.double().mT @ V.double() - eye).abs().max().item())
        for k, v in err.items():
            if not v <= Bn * eps:
                fail(f"syevj {dname} {tag}: {k} {v:.3g} > B eps = {Bn * eps:.3g}")
        if not bit_identical(lambda: eigh.syevj(M)):
            fail(f"syevj {dname} {tag}: two launches on one input differ")
        if not (sweeps < eigh.MAX_SWEEPS[Rw.dtype]).all():
            fail(f"syevj {dname} {tag}: a matrix reached the sweep cap")
        t_ops = 9 * Bn ** 3 * Cn / PEAK_FLOPS[dname] * 1e3
        t_bytes = M.element_size() * Cn * (2 * Bn * Bn + Bn) / PEAK_BYTES * 1e3
        ms = cuda_ms(lambda: eigh.syevj(M))
        out[tag] = dict(
            ms=ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            share_of_bound=max(t_ops, t_bytes) / ms,
            plain_ms=cuda_ms(lambda: eigh.syevj_ref(M), reps=1),
            library_ms=cuda_ms(lambda: torch.linalg.eigh(M), reps=3),
            library_kernels_per_matrix=device_kernel_launches(
                lambda: torch.linalg.eigh(M)) / Cn,
            sweeps=dict(sorted(collections.Counter(sweeps.tolist()).items())),
            plain_sweeps=dict(sorted(collections.Counter(sr.tolist()).items())),
            probe_launches=eigh.launches(), probe_library_calls=eigh.library_calls(),
            median_cond=(l64[:, 0] / l64[:, -1]).median().item(), **err)
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
        results[("syevj", name)] = cmf_ms[name]["eigh"]
        if dtype == torch.float64:
            results.update(cmf_kernel_checks(
                "float64_c8", *c8_inputs(x, m, Z, inv_glam, beta, parts)))
        del x, m, Rw, Z, Zc, inv_glam, beta, parts
        torch.cuda.empty_cache()
    print(json.dumps({"cmf_chunk_ms": cmf_ms, "chunk": [L, C, B, A]}))
    odd_shape_checks()
    return results


def max_abs_diff(a, b, rows=256, f64=False):
    """max |a - b| in f32 (in f64 with ``f64``), over slices of ``rows``
    along dim 0."""
    def cast(t):
        return t.double() if f64 else t.float()
    return max((cast(a[i:i + rows]) - cast(b[i:i + rows])).abs().max().item()
               for i in range(0, a.shape[0], rows))


def phase_conv_shapes():
    """Every distinct conv of trunk_s23 and trunk_s45 in bf16 at the CLI's
    configuration, and every distinct f32 conv of P2 (conv3), trunk_s23 and
    trunk_s45 at F32_BATCH, in the sub-batch each segment launches, through
    the single-conv entry as the segment launches it (channel offsets,
    pixel strides, split) on NaN-filled outputs, against the plain conv in
    its dtype: relative error, ms, achieved TFLOP/s and the tile the
    dispatch picked (trunk_fuse.conv_tile) with its column tiles, and the
    bound (trunk_bound) with the share of it. Each must go to the
    tensor-core kernel of its dtype as trunk_fuse.tensor_core_ok says, at
    the tile width trunk_fuse.conv_tile_width gives, each launch counted
    under its dtype and that width by trunk_fuse.conv_launches,
    stay within TRUNK_TOL, give the same bits on a second launch and leave
    every channel it does not own NaN. f32 rows also hold the kernel's and
    cuDNN-f32's (the plain conv's) errors against the conv in f64 on their
    first F64_WINDOWS windows. The f32 kernel's weight split of the largest
    f32 conv must equal trunk_fuse.split_tf32's bit for bit."""
    import torch
    from srcfinder_torch.device import resolve_device
    from srcfinder_torch.ops import trunk_fuse as tf
    resolve_device("cuda")                     # TF32 off for the plain f32 conv
    gen = torch.Generator(device="cuda").manual_seed(3232)
    rows, seen = [], set()
    cases = (("bfloat16", CLI_BATCH, (("trunk_s23", WIN // 2), ("trunk_s45", WIN // 16))),
             ("float32", F32_BATCH, (("fused_stage12", WIN), ("trunk_s23", WIN // 2),
                                     ("trunk_s45", WIN // 16))))
    for dname, batch, plans in cases:
        dtype = getattr(torch, dname)
        for name, side in plans:
            n = tf.sub_batch(name, batch, side, dtype)
            for c in tf.conv_plan(name, side):
                if (dname,) + c[1:] in seen:
                    continue
                seen.add((dname,) + c[1:])
                rows.append(_conv_shape_row(tf, gen, f"{name} {c.layer} {dname}", c, n, dtype))
            torch.cuda.empty_cache()
    # every M above is a multiple of the kernel's 128-row tile; trunk_s45 on
    # 3 windows gives inception 5a/5b (8 x 8 maps) 192 rows, a ragged tile
    ragged = {}
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        p45 = tf.pack_params("trunk_s45", seeded_params(gen, "trunk_s45", dtype))
        x45 = torch.randn(3, WIN // 16, WIN // 16, 480, generator=gen, device="cuda",
                          dtype=dtype).relu_()
        with torch.no_grad():
            got, ref = tf.trunk_s45(x45, p45), tf.trunk_s45_ref(x45, p45)
        ragged[dname] = max_abs_diff(got, ref) / ref.float().abs().max().item()
    # the f32 conv's weight split (conv_tf32x3_kernel_split) of the largest
    # f32 conv above, against its plain version (trunk_fuse.split_tf32)
    split = _split_row(tf, gen, max((c for name, side in cases[1][2]
                                     for c in tf.conv_plan(name, side)),
                                    key=lambda c: c.k * c.k * c.cin * c.cout))
    # a conv the rule refuses (6 input channels: a 16-byte vector of 4 f32
    # would cross a tap): no kernel takes it, so the wrapper raises
    x6, k6 = torch.ones(1, 4, 4, 6, device="cuda"), torch.ones(6, 8, device="cuda")
    b6, y6 = torch.zeros(1, 8, device="cuda"), torch.empty(1, 4, 4, 8, device="cuda")
    refused = dict(tile=tf.conv_tile(x6, k6, b6, y6), raised=False)
    try:
        tf.conv(x6, k6, b6, y6)
    except RuntimeError:
        refused["raised"] = True
    torch.cuda.synchronize()
    print(json.dumps({"conv_shapes": rows, "tol": TRUNK_TOL,
                      "trunk_s45_b3_max_rel_err": ragged, "refused_f32_cin6": refused,
                      "f32_weight_split": split}))
    if not split["bit_identical"]:
        fail(f"the f32 conv's weight split of {split['conv']} differs from split_tf32")
    if refused != dict(tile=0, raised=True):
        fail(f"an f32 conv of 6 input channels: {refused}, expected tile 0 and a raise")
    for dname, rel in ragged.items():
        if not rel <= TRUNK_TOL[dname]:
            fail(f"trunk_s45 on 3 windows in {dname}: relative error {rel:.3g}")
    return rows


def _split_row(tf, gen, c):
    """The f32 conv kernel's weight split (conv_tf32x3_kernel_split) of
    conv ``c`` (a ConvLaunch) at one window, hi and lo in a NaN-filled
    scratch, against trunk_fuse.split_tf32 bit for bit."""
    import torch
    ks = (c.cin, c.cout) if c.k == 1 else (c.k, c.k, c.cin, c.cout)
    k = torch.randn(ks, generator=gen, device="cuda") * (c.k * c.k * c.cin) ** -0.5
    x = torch.randn(1, c.side, c.side, c.cin, generator=gen, device="cuda")
    b = torch.zeros(1, c.cout, device="cuda")
    ho = (c.side + 2 * c.pad - c.k) // c.stride + 1
    y = torch.empty(1, ho, ho, c.cout, device="cuda")
    split = torch.full((2 * k.numel(),), float("nan"), device="cuda")
    tf.KERNEL.launch("srcf_conv_f32", *tf._conv_args(x, k, b, y, None, c.stride, c.pad),
                     split.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    hi, lo = tf.split_tf32(k)
    same = torch.equal(split.view(2, c.cout, -1).view(torch.int32),
                       torch.stack([hi, lo]).view(torch.int32))
    return dict(conv=c.layer, weights=k.numel(), bit_identical=same)


def _conv_shape_row(tf, gen, tag, c, n, dtype):
    """One row of phase_conv_shapes: conv ``c`` (a ConvLaunch) over ``n``
    windows in ``dtype``, seeded from ``gen``."""
    import torch
    nan, f32 = float("nan"), dtype == torch.float32
    fan_in = c.k * c.k * c.cin
    ks = (c.cin, c.cout) if c.k == 1 else (c.k, c.k, c.cin, c.cout)
    k = (torch.randn(ks, generator=gen, device="cuda") * fan_in ** -0.5).to(dtype)
    b = (torch.randn(1, c.cout, generator=gen, device="cuda") * 0.2).to(dtype)
    X = torch.randn(n, c.side, c.side, c.ldx, generator=gen, device="cuda",
                    dtype=dtype).relu_()
    ho = (c.side + 2 * c.pad - c.k) // c.stride + 1
    Y0 = torch.full((n, ho, ho, c.ldy0), nan, device="cuda", dtype=dtype)
    Y1 = (torch.full((n, ho, ho, c.ldy1), nan, device="cuda", dtype=dtype)
          if c.split < c.cout else None)
    x = X[..., c.x_off:c.x_off + c.cin]
    y0 = Y0[..., c.y_off:c.y_off + c.split]
    y1 = None if Y1 is None else Y1[..., :c.cout - c.split]

    def run():
        tf.conv(x, k, b, y0, y1, c.stride, c.pad)
    if not tf.tensor_core_ok(c, dtype):
        fail(f"{tag}: outside the tensor-core kernel's dispatch rule")
    tile = tf.conv_tile(x, k, b, y0, y1, c.stride, c.pad)
    # the rule's tile width (trunk_fuse.conv_tile_width): the fewest tiles of
    # <= 256 channels in bf16, <= 128 in f32
    want_tile = tf.conv_tile_width(c.cout, dtype)
    if tile != want_tile:
        fail(f"{tag}: the dispatch picked tile {tile}, not the tensor-core kernel's "
             f"{want_tile}")
    before = tf.conv_launches(dtype)
    run()
    torch.cuda.synchronize()
    got = y0 if y1 is None else torch.cat([y0, y1], dim=3)
    run()
    again = y0 if y1 is None else torch.cat([y0, y1], dim=3)
    same = torch.equal(got, again)
    del again
    counted = tf.conv_launches(dtype).get(tile, 0) - before.get(tile, 0)
    if counted != 2:
        fail(f"{tag}: conv_launches counted {counted} launches at width {tile} for two "
             f"{'f32' if f32 else 'bf16'} convs")
    row = dict(conv=tag, windows=n, side=c.side, cin=c.cin, cout=c.cout, k=c.k, tile=tile,
               column_tiles=-(-c.cout // tile))
    with torch.no_grad():
        xt = x.permute(0, 3, 1, 2)
        ref = tf._conv_ref(xt, k, b, c.stride, c.pad).permute(0, 2, 3, 1)
        ref_max = ref.float().abs().max().item()
        rel = max_abs_diff(got, ref) / ref_max
        if f32:
            # the f64 conv on the first F64_WINDOWS windows only: cuDNN's f64
            # conv runs at a small share of the f32 rate
            w64 = min(n, F64_WINDOWS)
            ref64 = tf._conv_ref(xt[:w64].double(), k.double(), b.double(), c.stride, c.pad
                                 ).permute(0, 2, 3, 1)
            max64 = ref64.abs().max().item()
            row.update(f64_windows=w64,
                       max_rel_err_vs_f64=max_abs_diff(got[:w64], ref64, f64=True) / max64,
                       cudnn_f32_max_rel_err_vs_f64=max_abs_diff(ref[:w64], ref64,
                                                                 f64=True) / max64)
            del ref64
        untouched = int(torch.isnan(Y0).sum().item()) + (
            0 if Y1 is None else int(torch.isnan(Y1).sum().item()))
    del ref, got
    ms = cuda_ms(run, reps=5)
    m = n * ho * ho
    ops = 2 * m * c.cout * fan_in
    row.update(M=m, ms=ms, tflops=ops / ms / 1e9, max_rel_err=rel, ref_max=ref_max,
               bit_identical=same)
    s = torch.finfo(dtype).bits // 8
    row.update(trunk_bound(ops, s * (n * c.side * c.side * c.cin + m * c.cout + fan_in * c.cout),
                           "float32" if f32 else "bfloat16"))
    row["share_of_bound"] = row["bound_ms"] / ms
    want = m * (c.ldy0 - c.split + (0 if Y1 is None else c.ldy1 - (c.cout - c.split)))
    tol = TRUNK_TOL["float32" if f32 else "bfloat16"]
    if not rel <= tol:
        fail(f"{tag}: relative error {rel:.3g} > {tol:g}")
    if not same:
        fail(f"{tag}: two launches on one input differ")
    if untouched != want:
        fail(f"{tag}: {untouched} NaN left in the outputs, expected {want} "
             "(channels it does not own, none it does)")
    return row


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
    family = {"front": ("front_kernel",),
              "conv3": ("conv_wgmma_kernel", "conv_tf32x3_kernel", "conv_tf32x3_kernel_split"),
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
            bound = trunk_bound(ops, elems * (torch.finfo(dtype).bits // 8), dname)
            layers[layer] = dict(ms=ms, **bound,
                                 share_of_bound=bound["bound_ms"] / ms if ms else None)
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


# The masks' dilations at the masks cell's shapes (ops/morph.py): a mask
# block (block_step 500 + ceil(mingrowarea 5 + 49)) grown by disk(49), and
# a 2801-line cloud map buffered by the r = 49 diamond (150 m at 3.1 m)
MORPH_R = 49
MORPH_SHAPES = (("disk", (554, SCENE[1])), ("diamond", (SCENE[0], SCENE[1])))


def morph_bound(H, W):
    """The dilation's least time (ms): H*W bytes in and H*W out at the
    card's bandwidth (its scans take O(1) operations a pixel)."""
    return dict(bound_ms=2 * H * W / PEAK_BYTES * 1e3, bound_by="bytes")


def phase_morph():
    """The masks' dilation kernel (ops/morph.py, csrc/morph.cu) at the masks
    cell's shapes: bit for bit against its plain version on the card and
    against scipy on the host, at seed densities 0, 1e-4, 1e-2, 0.5 and 1;
    the CUDA-event ms of a call on one 4 x 4 seed (back to back: the
    wrapper's table copy and launches count) and its two kernels' device ms
    (torch.profiler) beside their bound, the plain version's ms on the card
    and scipy's host ms. Prints one {"morph": ...} line and returns those
    readings by "<element>_<H>x<W>"."""
    import numpy as np
    import torch
    from scipy import ndimage
    from srcfinder_torch.core.morphology import disk
    from srcfinder_torch.ops import morph

    def scipy_dilation(m, element):
        if element == "disk":
            return ndimage.binary_dilation(m, structure=disk(MORPH_R, dtype=bool))
        for _ in range(MORPH_R):
            m = ndimage.binary_dilation(m)
        return m

    out = {}
    rng = np.random.default_rng(598)
    for element, (H, W) in MORPH_SHAPES:
        table = morph.halfwidths(element, MORPH_R)
        for density in (0.0, 1e-4, 1e-2, 0.5, 1.0):
            m = rng.random((H, W)) < density
            seeds = torch.from_numpy(m).cuda()
            got = morph.dilate(seeds, MORPH_R, element)
            if not torch.equal(got, morph.dilate_ref(seeds, table)):
                fail(f"morph: {element} {H} x {W} at density {density}: kernel != plain")
            if not torch.equal(got, morph.dilate(seeds, MORPH_R, element)):
                fail(f"morph: {element} at density {density}: two launches differ")
            if density in (1e-4, 1e-2) and not (got.cpu().numpy()
                                                == scipy_dilation(m, element)).all():
                fail(f"morph: {element} at density {density}: kernel != scipy")
        m = np.zeros((H, W), bool)
        m[H // 2:H // 2 + 4, W // 2:W // 2 + 4] = True
        seeds = torch.from_numpy(m).cuda()
        _, scipy_s = _host_s(lambda: scipy_dilation(m, element))
        prof = device_profile(lambda: [morph.dilate(seeds, MORPH_R, element)
                                       for _ in range(20)])
        kernel_ms = sum(t for name, t, _ in prof["top"]
                        if "row_reach_kernel" in name or "column_cover_kernel" in name) / 20
        out[f"{element}_{H}x{W}"] = dict(
            ms=cuda_ms(lambda: morph.dilate(seeds, MORPH_R, element), reps=50),
            kernel_device_ms=kernel_ms, **morph_bound(H, W),
            plain_ms=cuda_ms(lambda: morph.dilate_ref(seeds, table), reps=5),
            scipy_host_ms=scipy_s * 1e3, radius=MORPH_R)

    print(json.dumps({"morph": out, "gpu": nvidia_smi_line()}))
    return out


def phase_main_path(workdir):
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.flow.pipeline_cli import run_flightline
    from srcfinder_torch.ops import eigh, loo, moments

    gen = torch.Generator(device="cuda").manual_seed(2801)
    t0 = time.time()
    rdn, libf = write_scene(workdir, gen)
    wf = write_weights(workdir)
    setup_s = time.time() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    eigh.reset()
    t0 = time.time()
    prods = run_flightline(rdn, libf, wf, os.path.join(workdir, "out"),
                           prob_thr=0.0, do_ime=True, device="cuda",
                           progress=lambda msg: print(msg, flush=True))
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"masked_moments": moments.KERNEL.launches,
                "loo_sweep": loo.KERNEL.launches, "syevj": eigh.launches()}
    peak = torch.cuda.max_memory_allocated()
    if eigh.library_calls():
        fail(f"{eigh.library_calls()} eigensolves of the main path took the library route")

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
    return launches, prods, rdn, libf


def _host_s(fn, reps=1):
    """(result, host seconds of the fastest of ``reps`` calls of ``fn``)."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def phase_native(workdir, rdn, libf, prods):
    """The host runtime (phase 4a, "native" line; it runs right after phase 4,
    on its radiance and products): the library's build, then each function
    against its plain version on the host at the main path's sizes, with the
    host seconds of both in this call."""
    import numpy as np
    from srcfinder_torch.cmf.pipeline import active_range_for_library
    from srcfinder_torch.core import native
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.core.geotiff import _lzw_decode_py, _lzw_encode_py
    from srcfinder_torch.ops import build

    prebuilt = os.path.exists(native.LIBRARY.lib_path())
    t0 = time.time()
    build.build_all([native.LIBRARY])
    summary = dict(build_s=time.time() - t0, prebuilt=prebuilt,
                   compiler=subprocess.run(["c++", "--version"], capture_output=True,
                                           text=True).stdout.splitlines()[0],
                   flags=" ".join(build.CXX_FLAGS), have_native=native.HAVE_NATIVE)
    checks = {}

    # the CMF's active window over every column, from the radiance's memmap
    nl, ns, nb = SCENE
    mm = np.memmap(rdn, np.float32, "r", shape=(nl, nb, ns))
    a0, a1 = active_range_for_library(libf)
    plain, plain_s = _host_s(lambda: native.bil_window_to_lcb_plain(mm, a0 - 1, a1, 0, ns), 2)
    got, native_s = _host_s(lambda: native.bil_window_to_lcb(mm, a0 - 1, a1, 0, ns), 2)
    checks["repack"] = np.array_equal(got, plain)
    summary["repack"] = dict(shape=list(got.shape), native_s=native_s, plain_s=plain_s,
                             bit_equal=checks["repack"])
    del mm, got, plain

    # label8 of the masks the salience stage labels (the main path's
    # prob_thr 0 and the CLI's ppm*m threshold 250) and of a seeded
    # 12,000 x 598 mask at density 0.5, id for id against imlabel
    sal = open_envi(prods["saliency"]).load()[..., 0]
    ppmm = np.ascontiguousarray(open_envi(prods["cmf"]).load()[..., 3])
    masks = {"saliency_gt_0": sal > 0.0, "cmf_gt_250": ppmm > 250.0,
             "seeded_12000_d0.5": np.random.default_rng(12000).random((12000, ns)) < 0.5}
    summary["label8"] = {}
    for name, m in masks.items():
        ref, plain_s = _host_s(lambda: native.label8_plain(m), 2)
        got, native_s = _host_s(lambda: native.label8(m), 2)
        checks[f"label8_{name}"] = np.array_equal(got, ref)
        summary["label8"][name] = dict(shape=list(m.shape), components=int(got.max()),
                                       native_s=native_s, plain_s=plain_s,
                                       ids_equal=checks[f"label8_{name}"])

    # LZW: one training tile and the CMF band, native bytes against the
    # pure-Python codec's
    tile = np.abs(np.random.default_rng(256).normal(0, 200, (256, 256, 4))).astype(np.float32)
    summary["lzw"] = {}
    for name, arr in (("tile_256x256x4_f32", tile), ("cmf_band_2801x598_f32", ppmm)):
        data = arr.tobytes()
        enc, enc_s = _host_s(lambda: native.lzw_encode(data), 3)
        dec, dec_s = _host_s(lambda: native.lzw_decode(enc, len(data)), 3)
        penc, penc_s = _host_s(lambda: _lzw_encode_py(data))
        pdec, pdec_s = _host_s(lambda: _lzw_decode_py(penc))
        checks[f"lzw_{name}"] = enc == penc and dec == data and pdec == data
        summary["lzw"][name] = dict(bytes=len(data), compressed=len(enc), encode_s=enc_s,
                                    decode_s=dec_s, plain_encode_s=penc_s,
                                    plain_decode_s=pdec_s, bytes_equal=enc == penc,
                                    round_trip=dec == data)
    print(json.dumps({"native": summary}))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"native: {bad} differ from their plain versions")


def write_wind_grids(winddir):
    """Seeded f64 npz wind grids (WIND_GRIDS) under ``winddir``/hrrr/20200924
    and rtma/20200924, in the layout read_wind_grid reads: lat, lon, u, v,
    gust (and u_80, v_80 for HRRR's 80 m) and valid_date. Returns
    {kind: [paths]}."""
    import numpy as np
    rng = np.random.default_rng(20200924)
    paths = {}
    for kind, ((ny, nx), (dlat, dlon), names) in WIND_GRIDS.items():
        day = os.path.join(winddir, kind, "20200924")
        os.makedirs(day)
        lat = WIND_CENTER[0] + (np.arange(ny) - ny // 2)[:, None] * dlat * np.ones((1, nx))
        lon = WIND_CENTER[1] + (np.arange(nx) - nx // 2)[None, :] * dlon * np.ones((ny, 1))
        paths[kind] = []
        for name in names:
            stamp = re.search(r"\.(\d{10,12})z?\.", name).group(1).ljust(12, "0")
            fields = {f: rng.normal(mu, 1.5, (ny, nx)) for f, mu in
                      (("u", 3.0), ("v", 4.0), ("gust", 7.0))
                      + ((("u_80", 5.0), ("v_80", 6.0)) if kind == "hrrr" else ())}
            paths[kind].append(os.path.join(day, name))
            np.savez(paths[kind][-1], lat=lat, lon=lon, valid_date=(
                f"{stamp[:4]}-{stamp[4:6]}-{stamp[6:8]}T{stamp[8:10]}:{stamp[10:12]}:00"),
                **fields)
    return paths


def oracle_nearest(lon0, lat0, lon, lat):
    """The host f64 oracle: spherical-cosines distances (km) from the plume
    to every cell of the F-order raveled grid, numpy in float64 (the
    reference's windspeed.py:142-160), and the stable argsort's order."""
    import numpy as np
    x = np.radians(np.array([lon0, lat0], np.float64))
    latr = np.radians(lat)
    cosang = (np.sin(x[1]) * np.sin(latr)
              + (np.cos(x[1]) * np.cos(latr)) * np.cos(x[0] - np.radians(lon)))
    d = 6378.137 * np.arccos(np.clip(cosang, -1, 1))
    return d, np.argsort(d, kind="stable")


def wind_thresholds(sal):
    """The winds run's salience threshold on its saliency map ``sal``: the
    CLI's default 0.5 where WIND_CANDIDATES regions lie above it, one of
    them reaching into the plume (so an emission rate can be formed); else
    the highest such quantile of the map. Returns (prob_thr, source,
    {source: (threshold, regions)} of each one tried)."""
    import numpy as np
    from srcfinder_torch.core.morphology import imlabel
    valid = sal != -9999.0
    tries = [(0.5, "cli_default")] + [
        (float(np.quantile(sal[valid], q)), f"quantile_{q}")
        for q in (0.9995, 0.999, 0.998, 0.995, 0.99, 0.98, 0.95, 0.9, 0.8, 0.7, 0.6, 0.5)]
    seen = {}
    for thr, source in tries:
        n = int(imlabel(sal > thr).max())
        seen[source] = (thr, n)
        if WIND_CANDIDATES[0] <= n <= WIND_CANDIDATES[1] and sal[PLUME].max() > thr:
            return thr, source, seen
    fail(f"no salience threshold gives {WIND_CANDIDATES} candidates with one in "
         f"the plume: {seen}")


def phase_winds(workdir, rdn, libf, cmf_product):
    """The emission stage from the radiance (phase 4c): the main path's
    radiance in a watched directory, srcfinder_torch.flow.pipeline_cli.main
    with --watch --once --winds on wind grids at the real HRRR and RTMA
    sizes, with the trained-like weights (the seed-0 weights of the main
    path give every pixel a probability of 0.5, one candidate). Every wind
    statistic is held to the host f64 oracle over the same files, every
    emission rate to AvgIMEdivFetch20 x mean x 3600."""
    import numpy as np
    import pandas as pd
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect.fcn_pipeline import fcn_saliency_image, load_saliency_model
    from srcfinder_torch.flow import pipeline_cli, wind
    from srcfinder_torch.flow.emission import get_mean_wind_key, get_std_wind_key
    from srcfinder_torch.flow.windgrid import read_wind_grid
    from srcfinder_torch.ops import loo, moments

    # the threshold from the saliency the run will make of the same CMF
    wf = write_cnn_weights(workdir)
    band = np.asarray(open_envi(cmf_product).read_band(-1), np.float32)
    sal = fcn_saliency_image(band, load_saliency_model(wf, device="cuda"),
                             device="cuda").cpu().numpy()
    prob_thr, thr_source, thr_tries = wind_thresholds(sal)
    watched = os.path.join(workdir, "watched")
    winddir = os.path.join(workdir, "winds")
    out = os.path.join(workdir, "winds_out")
    os.makedirs(watched)
    for ext in ("", ".hdr"):
        os.symlink(rdn + ext, os.path.join(watched, os.path.basename(rdn) + ext))
    t0 = time.time()
    grids = write_wind_grids(winddir)
    setup_s = time.time() - t0
    try:
        # instrumentation: the job's products, every grid read and every
        # nearest-cell search of the run (plume, cells, selected indices),
        # and the host seconds of each kind
        jobs, reads, searches = [], [], []
        spent = {"grid_reads_s": 0.0, "searches_s": 0.0}
        real_run, real_read, real_nearest = (pipeline_cli.run_flightline,
                                             wind.read_wind_grid, wind.nearest_points)

        def run(*a, **k):
            jobs.append(real_run(*a, **k))
            return jobs[-1]

        def read(path, alt=10):
            t1 = time.perf_counter()
            reads.append((os.path.basename(path), alt))
            grid = real_read(path, alt)
            spent["grid_reads_s"] += time.perf_counter() - t1
            return grid

        def nearest(plume, grid, k, device="cuda"):
            t1 = time.perf_counter()
            d, idx = real_nearest(plume, grid, k, device=device)
            spent["searches_s"] += time.perf_counter() - t1
            searches.append((tuple(plume), grid.lon.size, idx))
            return d, idx

        pipeline_cli.run_flightline, wind.read_wind_grid, wind.nearest_points = (
            run, read, nearest)
        argv = ["--library", libf, "--weights", wf, "-o", out, "--prob_thr",
                repr(prob_thr), "--ppmm_thr", "250", "--ime", "--winds", winddir,
                "--wind-ext", ".npz", "--watch", watched, "--once"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        moments.KERNEL.reset()
        loo.KERNEL.reset()
        t0 = time.time()
        try:
            rc = pipeline_cli.main(argv)
        finally:
            pipeline_cli.run_flightline, wind.read_wind_grid, wind.nearest_points = (
                real_run, real_read, real_nearest)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches = {"masked_moments": moments.KERNEL.launches,
                    "loo_sweep": loo.KERNEL.launches}
        peak = torch.cuda.max_memory_allocated()
        if rc != 0 or len(jobs) != 1:
            fail(f"pipeline --watch --once returned {rc} after {len(jobs)} jobs")
        for k, n in launches.items():
            if n <= 0:
                fail(f"kernel {k} was not launched in the winds run")
        prods = jobs[0]
        dets = pd.read_csv(prods["detections_csv"])
        with open(prods["enriched_csv"]) as f:
            enriched = list(csv.DictReader(f))
        n = len(dets)
        if n < WIND_CANDIDATES[0] or len(enriched) != n or sorted(
                r["Candidate ID"] for r in enriched) != sorted(dets["Candidate ID"]):
            fail(f"enriched list: {len(enriched)} rows for {n} candidates")

        # the oracle over the same files: one read of each, one f64 search
        # per plume and grid geometry
        plumes = [(float(r["Plume Longitude (deg)"]), float(r["Plume Latitude (deg)"]))
                  for r in enriched]
        expect, ties, max_rel = {}, 0, 0.0
        for kind, alts in (("hrrr", (10, 80)), ("rtma", (10,))):
            files = [read_wind_grid(f, alt) for alt in alts for f in grids[kind]]
            lon = files[0].lon.ravel(order="F")
            lat = files[0].lat.ravel(order="F")
            for g in files:
                if not (np.array_equal(g.lon, files[0].lon)
                        and np.array_equal(g.lat, files[0].lat)):
                    fail(f"{kind} grids differ in geometry")
            for pl in plumes:
                d, order = oracle_nearest(pl[0], pl[1], lon, lat)
                got = [s[2] for s in searches if s[0] == pl and s[1] == lon.size]
                if len(got) != len(files):
                    fail(f"{len(got)} searches of the {kind} grid for plume {pl}")
                sel = order[:WIND_K]
                for idx in got:
                    if d[order[WIND_K]] - d[order[WIND_K - 1]] <= WIND_TIE_KM:
                        # a tie at the k-th cell: the cells closer than it
                        # must be chosen, the rest from the tied ones
                        ties += 1
                        tie = d[order[WIND_K - 1]]
                        below = set(order[d[order] < tie - WIND_TIE_KM].tolist())
                        tied = set(np.nonzero(np.abs(d - tie) <= WIND_TIE_KM)[0].tolist())
                        if not below <= set(idx.tolist()) <= below | tied:
                            fail(f"{kind} selection {idx} for {pl} breaks the tie rule")
                        sel = idx
                    elif not np.array_equal(idx, sel):
                        fail(f"{kind} selection {idx.tolist()} for {pl} != oracle "
                             f"{sel.tolist()}")
                for i, alt in enumerate(alts):
                    speeds = np.stack([np.sqrt(g.u ** 2 + g.v ** 2).ravel(order="F")[sel]
                                       for g in files[i * 3:(i + 1) * 3]])
                    expect[(pl, kind.upper(), alt)] = (speeds.mean(), speeds.std())
        emissions = 0
        for row, pl in zip(enriched, plumes):
            for kind, alt in (("HRRR", 10), ("HRRR", 80), ("RTMA", 10)):
                mk = get_mean_wind_key(kind, alt, WIND_K, 3)
                sk = get_std_wind_key(kind, alt, WIND_K, 3)
                if mk not in row or sk not in row:
                    fail(f"enriched list lacks {mk}")
                got = np.array([float(row[mk]), float(row[sk])])
                ref = np.array(expect[(pl, kind, alt)])
                rel = np.abs(got - ref) / np.abs(ref)
                max_rel = max(max_rel, float(rel.max()))
                if not (rel <= 1e-12).all():
                    fail(f"{row['Candidate ID']} {kind} {alt} m wind {got} != oracle {ref}")
            for kind in ("HRRR", "RTMA"):
                er = row[f"Emission Rate (kg/hr) [{kind} 10 m]"]
                if er == "NA":
                    continue
                want = (float(row["AvgIMEdivFetch20 (kg/m)"])
                        * float(row[get_mean_wind_key(kind, 10, WIND_K, 3)]) * 3600)
                if not abs(float(er) - want) <= 1e-12 * abs(want):
                    fail(f"{row['Candidate ID']} {kind} emission {er} != {want}")
                emissions += 1
        if not emissions:
            fail("no candidate got an emission rate")

        # one nearest-cell search at each grid size: the device's, the whole
        # call's (F-order ravel and copy to the card included) and the oracle's
        timing = {}
        for kind, paths in grids.items():
            g = read_wind_grid(paths[0])
            lon = g.lon.ravel(order="F")
            lat = g.lat.ravel(order="F")
            tl = torch.as_tensor(lon, device="cuda")
            tt = torch.as_tensor(lat, device="cuda")
            dev_ms, call_ms, oracle_ms = [], [], []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                wind._nearest_k(plumes[0][0], plumes[0][1], tl, tt, WIND_K)
                end.record()
                torch.cuda.synchronize()
                dev_ms.append(start.elapsed_time(end))
                t1 = time.perf_counter()
                wind.nearest_points(plumes[0], g, WIND_K, device="cuda")
                call_ms.append((time.perf_counter() - t1) * 1e3)
            for _ in range(5):
                t1 = time.perf_counter()
                oracle_nearest(plumes[0][0], plumes[0][1], lon, lat)[1][:WIND_K]
                oracle_ms.append((time.perf_counter() - t1) * 1e3)
            timing[kind] = dict(cells=int(lon.size),
                                device_ms_median=float(np.median(dev_ms)),
                                call_ms_median=float(np.median(call_ms)),
                                oracle_host_ms_median=float(np.median(oracle_ms)),
                                oracle_reps=len(oracle_ms))
    finally:
        shutil.rmtree(winddir, ignore_errors=True)
    summary = dict(prob_thr=prob_thr, ppmm_thr=250.0, threshold_source=thr_source,
                   threshold_tries=thr_tries, n_candidates=n,
                   grid_reads=len(reads), grid_reads_per_candidate=len(reads) / n,
                   searches=len(searches), emission_rates=emissions,
                   wind_max_rel_err=max_rel, ties=ties, setup_s=setup_s, run_s=run_s,
                   stage_s=prods["timers"], msf_flow_parts_s=spent, nearest_points=timing,
                   peak_mem_bytes=peak, launches=launches)
    print(json.dumps({"winds": summary}))
    return launches


def write_shapefile(path, polygons):
    """An ESRI .shp of Polygon records, each polygon a list of closed (k, 2)
    lon/lat rings, as persistence.read_shapefile_polygons reads it."""
    import struct
    import numpy as np
    recs = []
    for i, rings in enumerate(polygons):
        pts = np.concatenate(rings)
        parts = np.cumsum([0] + [len(r) for r in rings[:-1]])
        content = (struct.pack("<i", 5) + struct.pack("<4d", *pts.min(0), *pts.max(0))
                   + struct.pack("<ii", len(rings), len(pts))
                   + struct.pack(f"<{len(rings)}i", *parts) + pts.astype("<f8").tobytes())
        recs.append(struct.pack(">ii", i + 1, len(content) // 2) + content)
    body = b"".join(recs)
    allpts = np.concatenate([r for p in polygons for r in p])
    header = (struct.pack(">i", 9994) + bytes(20) + struct.pack(">i", (100 + len(body)) // 2)
              + struct.pack("<ii", 1000, 5)
              + struct.pack("<8d", *allpts.min(0), *allpts.max(0), 0, 0, 0, 0))
    with open(path, "wb") as f:
        f.write(header + body)


def write_dbf(path, field, values, width=20):
    """A dBASE III file with one character field."""
    import struct
    hsize = 32 + 32 + 1
    header = (bytes([3, 0, 0, 0]) + struct.pack("<I", len(values))
              + struct.pack("<HH", hsize, 1 + width) + bytes(20))
    fd = field.encode().ljust(11, b"\x00") + b"C" + bytes(4) + bytes([width, 0]) + bytes(14)
    with open(path, "wb") as f:
        f.write(header + fd + b"\r" + b"".join(b" " + v.encode().ljust(width) for v in values))


def write_campaign_plumes(root):
    """The campaign of FLOW_*: the plume list (lat/lon, line names,
    candidate ids, emission rates), the flightlines' .shp/.dbf, and the
    number of sources with a plume."""
    import numpy as np
    rng = np.random.default_rng(2021)
    (lat0, lat1), (lon0, lon1) = FLOW_BOX
    centers = lon0 + (np.arange(FLOW_STRIPS) + 0.5) * (lon1 - lon0) / FLOW_STRIPS
    strip = rng.integers(0, FLOW_STRIPS, FLOW_SOURCES)
    src_lon = centers[strip] + rng.uniform(-0.35, 0.35, FLOW_SOURCES) * FLOW_SWATH
    src_lat = rng.uniform(lat0 + 0.01, lat1 - 0.01, FLOW_SOURCES)
    src = rng.integers(0, FLOW_SOURCES, FLOW_PLUMES)
    day = rng.integers(0, FLOW_DAYS, FLOW_PLUMES)
    line = strip[src] * FLOW_DAYS + day
    names = [f"ang202109{20 + d:02d}t{15 + k // 10:02d}{(k % 10) * 6:02d}00"
             for k in range(FLOW_STRIPS) for d in range(FLOW_DAYS)]
    lat = src_lat[src] + rng.normal(0, 1.5e-4, FLOW_PLUMES)
    lon = src_lon[src] + rng.normal(0, 1.8e-4, FLOW_PLUMES)
    flux = rng.lognormal(np.log(300.0), 1.0, FLOW_PLUMES)
    order = np.lexsort((lat, line))
    seen = {}
    plumes = os.path.join(root, "stage0", "permian_plumes_ext.csv")
    with open(plumes, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Candidate ID", "Line name", "Plume Latitude (deg)",
                    "Plume Longitude (deg)", "Emission Rate (kg/hr) [HRRR 10 m]"])
        for i in order:
            name = names[line[i]]
            seen[name] = seen.get(name, 0) + 1
            w.writerow([f"{name}-{seen[name]}", name, f"{lat[i]:.6f}", f"{lon[i]:.6f}",
                        f"{flux[i]:.3f}"])
    # each line a swath-wide strip, shifted a little from day to day
    rings = []
    for k in range(FLOW_STRIPS):
        for d in range(FLOW_DAYS):
            a = centers[k] + (d - 1.5) * 1e-3 - FLOW_SWATH / 2
            b = a + FLOW_SWATH
            rings.append([np.array([[a, lat0], [a, lat1], [b, lat1], [b, lat0], [a, lat0]])])
    shp = os.path.join(root, "flightlines.shp")
    write_shapefile(shp, rings)
    write_dbf(shp[:-4] + ".dbf", "Flight_Run", names)
    return plumes, shp, len(np.unique(src))


def write_inversion_inputs(gdir):
    """A TROPOMI-style inversion of INV_GRID cells from INV_OBS retrievals
    in the layout of srcfinder-inversion: trop_H.csv (the Jacobian, each
    row a truncated Gaussian footprint of one cell's width, in steps of
    1/256, so the text is exact), trop_meta.csv (xch4 = back + H x_true +
    noise, back per overpass day), lat.csv and lon.csv. Returns H (f32)."""
    import numpy as np
    rng = np.random.default_rng(16384)
    ny, nx = INV_GRID
    os.makedirs(gdir)
    with open(os.path.join(gdir, "lat.csv"), "w") as f:
        f.write("lat\n" + "".join(f"{INV_ORIGIN[0] + (i + 0.5) * INV_CELL[0]}\n"
                                  for i in range(ny)))
    with open(os.path.join(gdir, "lon.csv"), "w") as f:
        f.write("lon\n" + "".join(f"{INV_ORIGIN[1] + (j + 0.5) * INV_CELL[1]}\n"
                                  for j in range(nx)))
    oi, oj = rng.uniform(0, ny, INV_OBS), rng.uniform(0, nx, INV_OBS)
    di = (np.arange(ny) + 0.5)[None, :, None] - oi[:, None, None]
    dj = (np.arange(nx) + 0.5)[None, None, :] - oj[:, None, None]
    r2 = di * di + dj * dj
    q = np.where(r2 <= FOOT_CELLS ** 2, np.rint(82 * np.exp(-r2 / 2)), 0).astype(np.int64)
    q = q.reshape(INV_OBS, ny * nx)
    H = (q / 256).astype(np.float32)
    x_true = np.clip(rng.normal(10.0, 4.0, ny * nx), 2.0, 25.0)
    y = H.astype(np.float64) @ x_true + rng.normal(0, 0.3, INV_OBS)
    if not np.abs(y).min() > 0.5:
        fail(f"an inversion observation lies near 0 ({np.abs(y).min()}): S_o is singular")
    days = rng.integers(0, 7, INV_OBS)
    back = 1860.0 + rng.normal(0, 5, 7)[days]
    with open(os.path.join(gdir, "trop_meta.csv"), "w") as f:
        f.write("day,lat,lon,xch4,back\n")
        for d, a, b, x, bk in zip(days, INV_ORIGIN[0] + oi * INV_CELL[0],
                                  INV_ORIGIN[1] + oj * INV_CELL[1], back + y, back):
            f.write(f"{d},{a:.4f},{b:.4f},{x:.4f},{bk:.4f}\n")
    table = np.array([format(k / 256, ".10g") for k in range(257)], dtype=object)
    with open(os.path.join(gdir, "trop_H.csv"), "w") as f:
        for row in q:
            f.write(",".join(table[row]) + "\n")
    return H


def write_windspeed_plumes(path, n=8):
    """``n`` candidates of the winds phase's scene time around WIND_CENTER,
    with IME columns, for srcfinder-windspeed."""
    import numpy as np
    rng = np.random.default_rng(8)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Candidate ID", "Plume Latitude (deg)", "Plume Longitude (deg)",
                    "AvgIMEdivFetch20 (kg/m)", "StdIMEdivFetch20 (kg/m)", "Aspect ratio20"])
        for k in range(n):
            w.writerow([f"ang20200924t211102-{k + 1}",
                        f"{WIND_CENTER[0] + rng.uniform(-0.05, 0.05):.5f}",
                        f"{WIND_CENTER[1] + rng.uniform(-0.05, 0.05):.5f}",
                        f"{rng.uniform(0.01, 0.05):.4f}", f"{rng.uniform(0, 0.01):.4f}",
                        f"{rng.uniform(0.3, 0.9):.3f}"])


def import_profile(stderr):
    """The processes of a run under PYTHONPROFILEIMPORTTIME, in start order:
    each one's seconds of imports in all and of torch's (with what it
    imports), and its imported module names."""
    procs = []
    for line in stderr.splitlines():
        if not line.startswith("import time:"):
            continue
        if "imported package" in line:
            procs.append([])
            continue
        _, cum, name = line.split("|")
        procs[-1].append((len(name) - len(name.lstrip()), name.strip(), int(cum) / 1e6))
    out = []
    for rows in procs:
        top = min(i for i, _, _ in rows)
        out.append(dict(imports_s=sum(s for i, _, s in rows if i == top),
                        torch_import_s=next((s for _, n, s in rows if n == "torch"), None),
                        modules=[n for _, n, _ in rows]))
    return out


def run_port_cli(argv, env, rc=0):
    """``python -m srcfinder_torch ARGV`` with every import traced; fails on
    an exit code other than ``rc`` or an import of jax or the JAX package
    anywhere in the process tree. Returns (seconds, stdout, [per-process
    profile])."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "srcfinder_torch", *argv], env=env,
                         capture_output=True, text=True, timeout=900)
    s = time.time() - t0
    if out.returncode != rc:
        fail(f"python -m srcfinder_torch {' '.join(argv)} exited {out.returncode}:\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    procs = import_profile(out.stderr)
    bad = sorted({m for p in procs for m in p["modules"]
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "srcfinder_tpu")})
    if bad:
        fail(f"python -m srcfinder_torch {argv[0]} imported {bad}")
    return s, out.stdout, procs


def inversion_flops(m, n):
    """Operations of bayesian_inversion and posterior_covariance at m
    observations and n cells, dense as they run: K = (H S_a) H^T + S_o,
    Cholesky m^3/3, its solve, S_a H^T v; LU of S_o 2m^3/3 and its solve
    for n columns, H^T X, two n x n inverses (2n^3 each)."""
    bayes = 2 * m * n * n + 2 * m * m * n + m * m + 2 * m * n + m ** 3 / 3 + 2 * m * m \
        + 2 * n * n * m + 2 * n * m
    post = 2 * m ** 3 / 3 + 2 * m * m * n + 2 * n * n * m + n * n + 4 * n ** 3
    return bayes, post


def spd_cond(K, L, iters=40):
    """cond(K) of a positive-definite K from its Cholesky factor L: power
    iteration for the largest eigenvalue, inverse iteration for the
    smallest (Rayleigh quotients, so a lower bound where not converged)."""
    import torch
    g = torch.Generator(device=K.device).manual_seed(0)
    v = torch.randn(K.shape[0], generator=g, device=K.device, dtype=K.dtype)
    u = v.clone()
    for _ in range(iters):
        v = K @ v
        v /= v.norm()
        u = torch.cholesky_solve(u[:, None], L)[:, 0]
        u /= u.norm()
    return float((v @ (K @ v)) / (u @ (K @ u)))


def inversion_check(gdir, H, dev):
    """The inversion job's files against direct calls of the port's
    functions on ``dev`` (bit for bit), its f32 result against the f64 one
    (INV_TOL), times, operations, bound, condition and peak memory."""
    import numpy as np
    import pandas as pd
    import torch
    from srcfinder_torch.flow.inversion import bayesian_inversion, posterior_covariance
    meta = pd.read_csv(os.path.join(gdir, "trop_meta.csv"))
    y = (pd.to_numeric(meta["xch4"]) - pd.to_numeric(meta["back"])).values.astype(np.float32)
    m, n = H.shape
    Ht, yt = torch.from_numpy(H).to(dev), torch.from_numpy(y).to(dev)
    x_a = torch.full((n,), 10.0, device=dev)
    S_a = torch.diag((0.5 * x_a) ** 2)
    S_o = torch.diag((0.1 * yt) ** 2)
    args = {"float32": (Ht, yt, x_a, S_a, S_o),
            "float64": tuple(a.double() for a in (Ht, yt, x_a, S_a, S_o))}
    res, ms, peak = {}, {}, {}
    for dt, (h, yy, xa, sa, so) in args.items():
        dtype = getattr(torch, dt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        x = bayesian_inversion(h, yy, xa, sa, so, device=dev, dtype=dtype)
        S = posterior_covariance(h, sa, so, device=dev, dtype=dtype)
        res[dt] = (x.cpu().numpy(), S.cpu().numpy())
        ms[dt] = {"bayesian_inversion": cuda_ms(
                      lambda: bayesian_inversion(h, yy, xa, sa, so, device=dev, dtype=dtype),
                      reps=3),
                  "posterior_covariance": cuda_ms(
                      lambda: posterior_covariance(h, sa, so, device=dev, dtype=dtype),
                      reps=3)}
        peak[dt] = torch.cuda.max_memory_allocated()
    x32, S32 = res["float32"]
    x64, S64 = res["float64"]
    cli = [np.loadtxt(os.path.join(gdir, f), delimiter=",").astype(np.float32)
           for f in ("x_hat.csv", "S_hat.csv")]
    for name, a, b in (("x_hat", cli[0], x32), ("S_hat", cli[1], S32)):
        if not np.array_equal(a, b):
            fail(f"the inversion CLI's {name} differs from a direct call: "
                 f"max |diff| {np.abs(a - b).max()}")
    err = {}
    for name, a, b in (("x_hat", x32, x64), ("S_hat", S32, S64)):
        if not np.isfinite(a).all():
            fail(f"the card's f32 {name} is not finite")
        err[name] = float(np.abs(a - b).max() / np.abs(b).max())
        if not err[name] <= INV_TOL:
            fail(f"the card's f32 {name} lies {err[name]} from its f64 solve (> {INV_TOL})")
    K = args["float64"][0] @ args["float64"][3] @ args["float64"][0].T + args["float64"][4]
    cond = spd_cond(K, torch.linalg.cholesky(K))
    del K
    t0 = time.time()
    np.savetxt(os.path.join(gdir, "S_hat_direct.csv"), S32, delimiter=",")
    csv_s = time.time() - t0
    flops = dict(zip(("bayesian_inversion", "posterior_covariance"), inversion_flops(m, n)))
    nbytes = {"bayesian_inversion": 4 * (m * n + n * n + m * m + m + 2 * n),
              "posterior_covariance": 4 * (m * n + 2 * n * n + m * m)}
    bound = {k: max(nbytes[k] / PEAK_BYTES, flops[k] / PEAK_FLOPS["float32"]) * 1e3
             for k in flops}
    return dict(m=m, n=n, min_abs_y=float(np.abs(y).min()), cond_K=cond, rel_err=err,
                tol=INV_TOL, cli_equals_direct_call=True, ms=ms, flops=flops,
                bytes=nbytes, bound_ms=bound, bound_by="operations",
                tflops_f32={k: flops[k] / ms["float32"][k] / 1e9 for k in flops},
                S_hat_csv_write_s=csv_s, peak_mem_bytes=peak)


def phase_flow_stages(workdir):
    """The msf-flow stages through the deployment's job map (phase 4f):
    srcfinder-jobs as python -m srcfinder_torch jobs over
    deployment/jobs.json, stage by stage (FLOW_STAGES), each job a process
    of the port's dispatcher; then srcfinder-windspeed on the card. Checks
    every job, the stages' outputs and the inversion (inversion_check)."""
    import numpy as np
    import pandas as pd
    import torch
    t_phase = time.time()
    torch.cuda.empty_cache()             # room for the jobs' processes
    root = os.path.join(workdir, "flow")
    stages = [os.path.join(root, f"stage{i}") for i in range(len(FLOW_STAGES))]
    for d in stages:
        os.makedirs(d)
    t0 = time.time()
    grids = write_wind_grids(os.path.join(root, "winds"))
    plumes, shp, n_src = write_campaign_plumes(root)
    H = write_inversion_inputs(os.path.join(stages[0], "trop"))
    os.symlink(grids["hrrr"][1], os.path.join(stages[3], os.path.basename(grids["hrrr"][1])))
    speed_csv = os.path.join(root, "ang20200924t211102_plumes_minppmm500.csv")
    write_windspeed_plumes(speed_csv)
    setup_s = time.time() - t0

    out = {"cluster": os.path.join(stages[1], "permian_plumes_cluster.csv"),
           "dedup": os.path.join(stages[2], "permian_plumes_dedup.csv"),
           "persistence": os.path.join(root, "permian_persistence.csv"),
           "nc": os.path.join(root, "hrrr_2020092421.nc")}
    sets = ([f"OUTFILE={out['cluster']}"], [f"OUTFILE={out['dedup']}"],
            [f"FLIGHTLINES={shp}", f"OUTFILE={out['persistence']}"],
            [f"OUTFILE={out['nc']}"])
    env = dict(os.environ, PYTHONPATH=HERE, PYTHONPROFILEIMPORTTIME="1")
    specs = os.path.join(HERE, "deployment", "jobs.json")
    with open(specs) as f:
        job_map = json.load(f)
    jobs, runners = [], []
    for watch, names, kv in zip(stages, FLOW_STAGES, sets):
        argv = ["jobs", specs, "--watch", watch, "--once", "--force",
                "--jobs", ",".join(names)] + [a for s in kv for a in ("--set", s)]
        s, stdout, procs = run_port_cli(argv, env)
        times = re.findall(r"^\[TIME\] (\S+): ([\d.]+) s$", stdout, re.M)
        info = re.search(r"submitted (\d+) job\(s\); (\d+) ok, (\d+) failed", stdout)
        if (not info or info[1] != info[2] or info[3] != "0" or int(info[1]) != len(times)
                or {t for t, _ in times} != {job_map[n]["command"][0] for n in names}):
            fail(f"jobs {names}: {stdout[-2000:]}")
        runners.append(dict(jobs=list(names), s=s, imports_s=procs[0]["imports_s"],
                            torch_import_s=procs[0]["torch_import_s"]))
        for (script, js), p in zip(times, procs[1:]):
            jobs.append(dict(script=script, s=float(js), imports_s=p["imports_s"],
                             torch_import_s=p["torch_import_s"]))

    # the stages' outputs
    clustered = pd.read_csv(out["cluster"])
    deduped = pd.read_csv(out["dedup"])
    pers = pd.read_csv(out["persistence"])
    n_clusters = clustered["Source ID"].nunique()
    if len(clustered) != FLOW_PLUMES or abs(n_clusters - n_src) > 0.02 * n_src:
        fail(f"cluster: {len(clustered)} rows, {n_clusters} sources (plumes came "
             f"from {n_src})")
    if not 0 < len(deduped) < len(clustered):
        fail(f"dedup kept {len(deduped)} of {len(clustered)} plumes")
    if len(pers) != deduped["Source identifier"].nunique() or not (
            pers["total.overflights"] == FLOW_DAYS).all():
        fail(f"persistence: {len(pers)} sources, overflights "
             f"{pers['total.overflights'].value_counts(dropna=False).to_dict()}")
    with open(out["nc"], "rb") as f:
        engine = "netcdf4" if f.read(4) == b"\x89HDF" else "classic"

    # srcfinder-windspeed on the card over the HRRR grids
    speed_out = os.path.join(root, "windspeed.csv")
    s, _, procs = run_port_cli(["windspeed", "-p", speed_csv, "-w",
                                os.path.join(root, "winds", "hrrr"), "--wind-ext", ".npz",
                                "-o", speed_out], env)
    jobs.append(dict(script="srcfinder-windspeed", s=s, imports_s=procs[0]["imports_s"],
                     torch_import_s=procs[0]["torch_import_s"]))
    speed = pd.read_csv(speed_out)
    mean = speed["Wind Mean (m/s) [HRRR 10 m, 10 nearest points for each of 3 closest times]"]
    er = speed["Emission Rate (kg/hr) [HRRR 10 m]"]
    want = speed["AvgIMEdivFetch20 (kg/m)"] * mean * 3600
    if not (np.isfinite(mean).all() and (mean > 0).all()
            and np.allclose(er, want, rtol=1e-12, atol=0)):
        fail(f"windspeed: means {mean.tolist()}, emissions {er.tolist()}")

    inv = inversion_check(os.path.join(stages[0], "trop"), H, torch.device("cuda"))
    summary = dict(plumes=FLOW_PLUMES, sources=n_src, flightlines=FLOW_STRIPS * FLOW_DAYS,
                   clusters=int(n_clusters), deduped=len(deduped),
                   persistence_sources=len(pers), nc_engine=engine,
                   windspeed_candidates=len(speed), setup_s=setup_s, runners=runners,
                   jobs=jobs, inversion=inv, phase_s=time.time() - t_phase)
    print(json.dumps({"flow_stages": summary}))
    shutil.rmtree(root, ignore_errors=True)


def write_covid_campaign(root, rng):
    """Phase 4g's COVID campaign (TQ_*): the curated list in the real file's
    comma format, a robust column-stats CSV for every flightline but
    TQ_REGEN (half in the reference's _clip spelling), and for those the
    CMF products at the real flightline length (TQ_CMF_LINES x ANG_NCOLS x
    4 bands, f32, BIP with the CMF CLI's band names; the CMF band's column
    medians are the flightline's profile). Returns (curated, stats_dir,
    cmf_dir, severities, regenerated names)."""
    import numpy as np
    import pandas as pd
    from srcfinder_torch.cmf.pipeline import _BAND_NAMES_4
    from srcfinder_torch.core.envi import create_envi
    from srcfinder_torch.triage.profile import ANG_NCOLS
    sev = np.concatenate([np.full(n, s) for s, n in TQ_SEVERITIES])
    rng.shuffle(sev)
    names = [f"ang2020{4 + i // 56:02d}{1 + (i // 2) % 28:02d}t{i:06d}_ch4mf_v2y1_img"
             for i in range(len(sev))]
    maybe = np.flatnonzero(sev == 0.5)
    spiked = (sev >= 1) | np.isin(np.arange(len(sev)), maybe[::2])
    # two of each severity are profiled again: at 0.5 one spiked, one clean
    regen = [int(i) for s in (0.0, 1.0, 2.0) for i in np.flatnonzero(sev == s)[:2]]
    regen += [int(maybe[0]), int(maybe[1])]
    regen = sorted(regen)[:TQ_REGEN]
    stats_dir, cmf_dir = os.path.join(root, "stats"), os.path.join(root, "cmfs")
    os.makedirs(stats_dir)
    os.makedirs(cmf_dir)
    cols = np.linspace(0, 3, ANG_NCOLS)
    for i, name in enumerate(names):
        # tests/test_triage.py::test_covid_oracle_harness's profiles
        med = 500 + 30 * np.sin(cols) + rng.normal(0, 0.5, ANG_NCOLS)
        if spiked[i]:
            med[::7] += 500.0
        if i not in regen:
            spell = "_clip_column_stats.csv" if i % 2 else "_column_stats.csv"
            npix = rng.integers(int(0.9 * TQ_CMF_LINES), TQ_CMF_LINES, ANG_NCOLS)
            pd.DataFrame({"npix": npix, "med": med, "mad": rng.uniform(20, 40, ANG_NCOLS),
                          "p05": med - 60, "p95": med + 60}).to_csv(
                os.path.join(stats_dir, name + spell), index=False)
            continue
        meta = {"lines": TQ_CMF_LINES, "samples": ANG_NCOLS, "bands": 4, "interleave": "bip",
                "data type": 4, "byte order": 0, "header offset": 0,
                "data ignore value": -9999, "band names": list(_BAND_NAMES_4),
                "map info": ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1",
                             "11", "North", "WGS-84", "units=Meters", "rotation=0"]}
        mm = create_envi(os.path.join(cmf_dir, name + ".hdr"), meta).open_memmap(
            interleave="source", writable=True)                  # (L, C, 4)
        for r0 in range(0, TQ_CMF_LINES, 2000):
            r1 = min(TQ_CMF_LINES, r0 + 2000)
            blk = np.empty((r1 - r0, ANG_NCOLS, 4), np.float32)
            blk[..., :3] = rng.uniform(1, 12, (r1 - r0, ANG_NCOLS, 3))
            blk[..., 3] = med[None, :] + rng.normal(0, 50, (r1 - r0, ANG_NCOLS))
            if r0 == 0:
                blk[:40, :, 3] = -9999.0                 # the line's start: nodata
            mm[r0:r1] = blk
        mm.flush()
        del mm
    curated = os.path.join(root, "COVID_systematics.txt")
    with open(curated, "w") as f:
        f.writelines(f"{n}, {s:g}\n" for n, s in zip(names, sev))
    return curated, stats_dir, cmf_dir, sev, [names[i] for i in regen]


def column_stats_ms(band):
    """column_stats (robust) of one CMF band: the card's device ms (CUDA
    events, median of 10 after a warm-up) and the CPU's ms (median of 3)."""
    import numpy as np
    import torch
    from srcfinder_torch.triage.profile import column_stats
    x = torch.from_numpy(band)
    m = ~((x == -9999) | torch.isnan(x)) & (x > 0)
    xd, md = x.cuda(), m.cuda()
    column_stats(xd, md, robust=True)
    dev = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        column_stats(xd, md, robust=True)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    cpu = []
    for _ in range(3):
        t0 = time.perf_counter()
        column_stats(x, m, robust=True)
        cpu.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(dev)), float(np.median(cpu))


def covid_oracle_check(root, env):
    """Phase 4g (a): covid-oracle through the dispatcher on the card and on
    the CPU, each regenerating the missing profiles into its own stats
    directory; the card's run again with --expected set to the CPU's
    report (exit 0), then with one count changed (exit 1)."""
    import numpy as np
    import pandas as pd
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.triage.covid import _parse_counts
    from srcfinder_torch.triage.profile import ANG_NCOLS
    t_all = t0 = time.time()
    curated, stats, cmfs, sev, regen = write_covid_campaign(
        root, np.random.default_rng(280))
    setup_s = time.time() - t0
    cpu_stats = os.path.join(root, "stats_cpu")
    shutil.copytree(stats, cpu_stats)
    runs = {}
    # the card's run at the CLI's default device, then the CPU's
    for dev, sdir, flag in (("cuda", stats, []), ("cpu", cpu_stats, ["--device", "cpu"])):
        s, out, procs = run_port_cli(["covid-oracle", curated, "--stats-dir", sdir,
                                      "--cmf-dir", cmfs, *flag], env)
        runs[dev] = dict(s=s, out=out, imports_s=procs[0]["imports_s"],
                         torch_import_s=procs[0]["torch_import_s"])
    if runs["cuda"]["out"] != runs["cpu"]["out"]:
        fail(f"covid-oracle: the card's report differs from the CPU's:\n"
             f"{runs['cuda']['out'][-3000:]}\n{runs['cpu']['out'][-3000:]}")
    counts = _parse_counts(runs["cuda"]["out"].splitlines())
    strong = counts[("", "Strong Systematics (True Positive)")]
    if strong != int((sev == 2).sum()) or runs["cuda"]["out"].count("profiling") != len(regen):
        fail(f"covid-oracle: {strong} of {int((sev == 2).sum())} severity-2 flightlines "
             f"flagged; {runs['cuda']['out'].count('profiling')} profiled")
    stats_err = {}
    for name in regen:
        a, b = (pd.read_csv(os.path.join(d, name + "_column_stats.csv"))
                for d in (stats, cpu_stats))
        if list(a.columns) != ["npix", "med", "mad", "p05", "p95"] or len(a) != len(b) or \
                not np.array_equal(a["npix"], b["npix"]):
            fail(f"covid-oracle: {name}'s regenerated npix differ from the CPU's")
        a, b = a.to_numpy(float), b.to_numpy(float)
        stats_err[name] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        if not stats_err[name] <= TQ_STATS_RTOL:
            fail(f"covid-oracle: {name}'s regenerated stats lie {stats_err[name]} from the "
                 f"CPU's (> {TQ_STATS_RTOL})")
    expected = os.path.join(root, "expected.txt")
    with open(expected, "w") as f:
        f.write(runs["cpu"]["out"])
    s, out, procs = run_port_cli(["covid-oracle", curated, "--stats-dir", stats,
                                  "--expected", expected], env)
    if "ALL COUNTS MATCH" not in out:
        fail(f"covid-oracle --expected: {out[-2000:]}")
    runs["expected"] = dict(s=s, imports_s=procs[0]["imports_s"],
                            torch_import_s=procs[0]["torch_import_s"])
    line = next(ln for ln in runs["cpu"]["out"].splitlines() if ln.startswith("Any Systematics"))
    label, n = line.rsplit("= ", 1)
    with open(expected, "w") as f:
        f.write(runs["cpu"]["out"].replace(line, f"{label}= {int(n) + 1}", 1))
    s, out, _ = run_port_cli(["covid-oracle", curated, "--stats-dir", stats,
                              "--expected", expected], env, rc=1)
    if "MISMATCH" not in out:
        fail(f"covid-oracle with a changed count: {out[-2000:]}")
    runs["changed"] = dict(s=s)
    runs_s = time.time() - t_all - setup_s
    # the regenerated files' reads and one band's column statistics
    reads = {}
    for name in regen:
        t0 = time.perf_counter()
        band = np.asarray(open_envi(os.path.join(cmfs, name)).read_band(-1), np.float32)
        reads[name] = time.perf_counter() - t0
    t0 = time.time()
    dev_ms, cpu_ms = column_stats_ms(band)
    timing_s = time.time() - t0
    for r in runs.values():
        r.pop("out", None)
    return dict(flightlines=len(sev), severities={f"{s:g}": int((sev == s).sum())
                                                  for s, _ in TQ_SEVERITIES},
                regenerated=len(regen), cmf_shape=[TQ_CMF_LINES, ANG_NCOLS, 4], setup_s=setup_s,
                counts={f"{k[0]}|{k[1]}": v for k, v in counts.items()},
                regenerated_stats_max_rel_err=max(stats_err.values()), stats_rtol=TQ_STATS_RTOL,
                runs=runs, runs_s=runs_s, read_s=reads, column_stats_device_ms=dev_ms,
                column_stats_cpu_ms=cpu_ms, column_stats_timing_s=timing_s,
                check_s=time.time() - t_all)


def consensus_rules(labels):
    """The merge's six rules for one candidate's labels, written apart from
    the port's consensus_label: one label stands; any Reject rejects;
    ambiguous only, both sides, or ambiguous with one side are Ambiguous;
    negatives only are False Enhancement; positives only are Super Plume
    if one says so, else Plume."""
    pos, neg = {"Plume", "Super Plume"}, {"Artifact", "Cloud", "False Enhancement"}
    amb = {"Ambiguous", "Duplicate", "Background"}
    s = set(labels)
    if len(s) == 1:
        return s.pop()
    if "Reject" in s:
        return "Reject"
    if s <= neg:
        return "False Enhancement"
    if s <= pos:
        return "Super Plume" if "Super Plume" in s else "Plume"
    return "Ambiguous"


def write_tagger_season(root, rng):
    """Phase 4g (b)'s campaign: TQ_FLIGHTLINES CMF products of the main
    path's scene size (SCENE lines x samples, 4 bands f32 BIP, UTM at 3.1
    m) with a saliency and a label-image sibling each, TQ_CANDIDATES
    campaign candidates per flightline written as every user's starting
    autosave (shared cids), the settings, the flag rules, and each user's
    seeded labels and flags. Flightline 0 reaches every rule of the merge,
    flightline 1 is rejected by its Coverage flag, flightline 2's users
    disagree on it (resolved to ambiguous)."""
    import numpy as np
    import pandas as pd
    from srcfinder_torch.core.envi import create_envi, open_envi
    from srcfinder_torch.core.geo import mapinfo, sl2latlon
    from srcfinder_torch.core.labels import DIFFSRC, FALSESRC, POINTSRC
    from srcfinder_torch.qc import labels as ql
    nl, ns = SCENE[:2]
    data, out = os.path.join(root, "data"), os.path.join(root, "out")
    os.makedirs(data)
    mapi = ["UTM", "1", "1", "272247.15", "3992010.65", "3.1", "3.1", "11", "North",
            "WGS-84", "units=Meters", "rotation=0"]
    cids = [chr(ord("A") + k) for k in range(TQ_CANDIDATES)]
    vocab = ql.POSLABS + ql.NEGLABS + ql.AMBLABS
    rules0 = (("Plume", "Reject", "Plume"), ("Ambiguous", "Duplicate", "Background"),
              ("Plume", "False Enhancement", "Plume"), ("Ambiguous", "Plume", "Super Plume"),
              ("Artifact", "Cloud", "False Enhancement"), ("Plume", "Super Plume", "Plume"),
              ("Plume", "Plume", "Plume"), ("Cloud", "Cloud", "Cloud"))
    names, cands, labels, flags = [], {}, {}, {}
    for i in range(TQ_FLIGHTLINES):
        name = f"ang2020092{i}t21110{i}_cmf_v2y1_img"
        names.append(name)
        meta = {"lines": nl, "samples": ns, "bands": 4, "interleave": "bip", "data type": 4,
                "byte order": 0, "header offset": 0, "data ignore value": -9999,
                "map info": mapi}
        rows = rng.integers(100, nl - 100, TQ_CANDIDATES)
        cols = rng.integers(40, ns - 40, TQ_CANDIDATES)
        cube = np.empty((nl, ns, 4), np.float32)
        cube[..., :3] = rng.uniform(1, 12, (nl, ns, 3))
        cube[..., 3] = rng.normal(100, 60, (nl, ns))
        sal = np.clip(rng.normal(0.1, 0.05, (nl, ns)), 0, 1).astype(np.float32)
        lab = np.zeros((nl, ns), np.int16)
        for k, (r, c) in enumerate(zip(rows, cols)):
            cube[r - 6:r + 7, c - 4:c + 5, 3] += 900 + 100 * k
            sal[r - 8:r + 9, c - 6:c + 7] = 0.9
            lab[r - 3:r + 4, c - 3:c + 4] = (POINTSRC, DIFFSRC, FALSESRC)[k % 3]
        cube[:20, :, :] = -9999.0
        for suffix, arr in (("", cube), ("_saliency", sal[..., None]),
                            ("_labclass", lab[..., None])):
            m = dict(meta, bands=arr.shape[2], **{"data type": 4 if arr.dtype == np.float32
                                                  else 2})
            mm = create_envi(os.path.join(data, name + suffix + ".hdr"), m).open_memmap(
                interleave="source", writable=True)
            mm[:] = arr
            mm.flush()
            del mm
        lat, lon = sl2latlon(cols.astype(float), rows.astype(float),
                             mapinfo=mapinfo(open_envi(os.path.join(data, name))))
        lid = ql.cmff_to_lid(name)
        cands[name] = pd.DataFrame({ql.LIDCOL: lid, ql.CIDCOL: cids, ql.LATCOL: lat,
                                    ql.LONCOL: lon, ql.LABCOL: ql.PLUMELAB})
        for u, user in enumerate(TQ_USERS):
            labels[name, user] = ([r[u] for r in rules0] if i == 0 else
                                  [vocab[j] for j in rng.integers(len(vocab), size=len(cids))])
            cover = "bad" if i == 1 or (i == 2 and u == 0) else "good"
            flags[name, user] = {"Coverage": cover,
                                 "Clouds": ("none", "some")[int(rng.integers(2))],
                                 "Artifacts": ("none", "some")[int(rng.integers(2))],
                                 "Usernotes": f"{user} on line {i}"}
    for user in TQ_USERS:
        os.makedirs(os.path.join(out, user))
        for name in names:
            cands[name].to_csv(os.path.join(out, user, name + "_cid.csv"), index=False)
    cfg = os.path.join(root, "settings.json")
    with open(cfg, "w") as f:
        json.dump({"users": list(TQ_USERS), "datapath": data}, f)
    lidf = os.path.join(root, "lidfilters.json")
    with open(lidf, "w") as f:
        json.dump(TQ_LIDFILTERS, f)
    return dict(data=data, out=out, cfg=cfg, lidfilters=lidf, names=names, cids=cids,
                labels=labels, flags=flags)


def png_rgb(data):
    """The tagger's PNG (8-bit RGB, filter 0 on every row) -> (h, w, 3)."""
    import struct
    import zlib
    import numpy as np
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, color = ihdr[:4]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if depth != 8 or color != 2 or raw.size != h * (1 + 3 * w):
        fail(f"PNG of {w} x {h}, depth {depth}, colour type {color}, {raw.size} bytes")
    raw = raw.reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        fail("PNG rows with a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def tagger_png_size(view, dims, out_max=2048):
    """(width, height) of the tagger's PNG of ``view`` (x0, y0, x1, y1)
    over an image of ``dims`` (width, height): the view clipped to the
    image and magnified by the integer factor that brings its longer side
    nearest ``out_max`` from below (none past it)."""
    x0, y0 = max(0, view[0]), max(0, view[1])
    w = min(dims[0], max(x0 + 1, view[2])) - x0
    h = min(dims[1], max(y0 + 1, view[3])) - y0
    k = max(1, out_max // max(w, h)) if max(w, h) < out_max else 1
    return w * k, h * k


def geotiff_epsg(path):
    """The EPSG code of a little-endian GeoTIFF's GeoKeyDirectory (keys
    3072 or 2048), read from its first IFD without decoding the pixels."""
    import struct
    with open(path, "rb") as f:
        blob = f.read(1 << 16)
        if blob[:2] != b"II":
            fail(f"{path}: not a little-endian TIFF")
        ifd = struct.unpack("<I", blob[4:8])[0]
        f.seek(ifd)
        n = struct.unpack("<H", f.read(2))[0]
        entries = [struct.unpack("<HHII", f.read(12)) for _ in range(n)]
        for tag, typ, count, value in entries:
            if tag == 34735:                         # GeoKeyDirectory, SHORTs
                f.seek(value)
                keys = struct.unpack(f"<{count}H", f.read(2 * count))
                for i in range(4, count, 4):
                    if keys[i] in (3072, 2048):
                        return keys[i + 3]
    return None


class TaggerClient:
    """Requests to one tagger process: each checked for status 200 and its
    content type, timed under its endpoint's name."""

    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"
        self.ms = {}

    def call(self, path, body=None, ctype="application/json"):
        import urllib.request
        req = urllib.request.Request(self.base + path, method="GET" if body is None else "POST",
                                     data=None if body is None else json.dumps(body).encode())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            status, got, data = r.status, r.headers["Content-Type"], r.read()
        key = ("GET " if body is None else "POST ") + path.split("?")[0]
        self.ms.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        if status != 200 or got != ctype:
            fail(f"tagger {key}: status {status}, {got}")
        if ctype == "application/json":
            data = json.loads(data)
            if isinstance(data, dict) and "error" in data:
                fail(f"tagger {key}: {data['error']}")
        return data


def start_tagger(season, user, env, logdir, extra=()):
    """``python -m srcfinder_torch tagger`` for ``user`` at its user_port,
    its outputs in files (the import trace outgrows a pipe's buffer);
    returns (process, client, start seconds, log paths) once /api/info
    answers."""
    import urllib.error
    from srcfinder_torch.qc.webapp import user_port
    port = user_port(TQ_USERS, user)
    logs = (os.path.join(logdir, f"{user}.out"), os.path.join(logdir, f"{user}.err"))
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, "-m", "srcfinder_torch", "tagger", "--config",
                                 season["cfg"], "--user", user, "--output", season["out"],
                                 *extra], env=env, stdout=out, stderr=err)
    client = TaggerClient(port)
    while True:
        try:
            client.call("/api/info")
            break
        except (urllib.error.URLError, ConnectionError):
            if proc.poll() is not None or time.time() - t0 > 600:
                proc.kill()
                with open(logs[1]) as f:
                    fail(f"tagger for {user} did not start (rc {proc.poll()}): "
                         f"{f.read()[-3000:]}")
            time.sleep(0.1)
    client.ms.clear()
    return proc, client, time.time() - t0, logs


def tagger_session(season, user, client):
    """One user's scripted session over every flightline (phase 4g (b)).
    Returns the clicks' distances to click_to_pixel's pixel and the PNG
    sizes."""
    from srcfinder_torch.qc.webapp import click_to_pixel
    layers = "rgb,cmf,salience,labels,candidates"
    if b"srcfinder QC tagger" not in client.call("/", ctype="text/html"):
        fail("tagger page")
    dists, sizes = [], set()
    for name in season["names"]:
        info = client.call("/api/info")
        if name not in info["todo"]:
            fail(f"tagger: {name} not in {user}'s todo list")
        b = client.call(f"/api/bounds?fl={name}")
        dims = [b["width"], b["height"]]
        client.call(f"/api/flags?fl={name}")
        fit = png_rgb(client.call(f"/img?fl={name}&layers={layers}", ctype="image/png"))
        if fit.shape[1::-1] != tagger_png_size([0, 0, *dims], dims):
            fail(f"tagger: the fitted PNG is {fit.shape[1::-1]} for {dims}")
        sizes.add(("fit", fit.shape[1], fit.shape[0]))
        view = client.call("/api/view", {"op": "zoom", "view": None, "dims": dims,
                                         "f": 0.5})["view"]
        q = "&".join(f"{k}={v}" for k, v in zip(("x0", "y0", "x1", "y1"), view))
        zoom = png_rgb(client.call(f"/img?fl={name}&layers={layers}&{q}", ctype="image/png"))
        sizes.add(("zoom", zoom.shape[1], zoom.shape[0]))
        seeded = client.call(f"/api/candidates?fl={name}")
        if [c["cid"] for c in seeded] != season["cids"]:
            fail(f"tagger: {user}'s {name} starts with {[c['cid'] for c in seeded]}")
        for cid, lab in zip(season["cids"], season["labels"][name, user]):
            client.call("/api/relabel", {"fl": name, "cid": cid, "label": lab})
        if zoom.shape[1::-1] != tagger_png_size(view, dims):
            fail(f"tagger: the zoomed PNG is {zoom.shape[1::-1]} for view {view}")
        # a click a quarter into the zoomed view
        imgh, imgw = zoom.shape[:2]
        offx, offy = imgw * 0.25 + 0.5, imgh * 0.25 + 0.5
        client.call("/api/add", {"fl": name, "view": view, "dims": dims, "offx": offx,
                                 "offy": offy, "imgw": imgw, "imgh": imgh, "label": "Plume"})
        added = [c for c in client.call(f"/api/candidates?fl={name}")
                 if c["cid"] not in season["cids"]]
        col, row = click_to_pixel(view, dims, offx, offy, imgw, imgh)
        if len(added) != 1:
            fail(f"tagger: {len(added)} candidates added by one click")
        dists.append(max(abs(added[0]["col"] - col), abs(added[0]["row"] - row)))
        client.call("/api/delete", {"fl": name, "cid": added[0]["cid"]})
        client.call("/api/flags", {"fl": name, "values": season["flags"][name, user]})
        client.call("/api/submit", {"fl": name})
    info = client.call("/api/info")
    log = client.call("/api/log")["text"]
    if sorted(info["done"]) != sorted(season["names"]) or "submitted" not in log:
        fail(f"tagger: {user} ends with done {info['done']}")
    return dists, sizes


def check_merge(season, prefix):
    """collect-qc's label files against the seeded table: the flightline
    verdicts, and every candidate row's label equal to consensus_rules over
    the users' labels (all Reject on a flightline a flag rejects)."""
    import pandas as pd
    lid = pd.read_csv(prefix + "_lid_filt.csv")
    verdict = {n: ("Reject" if i == 1 else "Ambiguous" if i == 2 else "Accept")
               for i, n in enumerate(season["names"])}
    for _, r in lid.iterrows():
        if r["Label"] != verdict[r["Line name"] + "_cmf_v2y1_img"]:
            fail(f"collect-qc: flightline {r['Line name']} labelled {r['Label']}")
    cid = pd.read_csv(prefix + "_cid_filt.csv")
    for i, name in enumerate(season["names"]):
        for k, c in enumerate(season["cids"]):
            labs = [season["labels"][name, u][k] for u in TQ_USERS]
            want = "Reject" if i == 1 else consensus_rules(labs)
            got = cid.loc[(cid["Line name"] + "_cmf_v2y1_img" == name)
                          & (cid["Candidate ID"].astype(str) == c), "Label"]
            if len(got) != len(TQ_USERS) or set(got) != {want}:
                fail(f"collect-qc: {name} {c} labels {got.tolist()}, the rules give {want} "
                     f"from {labs}")
    if len(cid) != len(season["names"]) * len(season["cids"]) * len(TQ_USERS):
        fail(f"collect-qc: {len(cid)} candidate rows")
    return dict(lid_rows=len(lid), cid_rows=len(cid), final_rows=len(pd.read_csv(
        prefix + "_cid_filt_nodup_norej_noamb.csv")),
        labels=cid["Label"].value_counts().to_dict())


def tagger_season_check(root, env):
    """Phase 4g (b): one labelling season, three users' taggers one after
    another (the first with --precache, the second with --precache on the
    same cache, which must rewrite nothing), then collect-qc."""
    import numpy as np
    t_all = t0 = time.time()
    season = write_tagger_season(root, np.random.default_rng(2801))
    setup_s = time.time() - t0
    gcache, logdir = os.path.join(root, "gtif"), os.path.join(root, "logs")
    os.makedirs(logdir)
    starts, ms, dists, sizes, imports, session_s, stop_s = {}, {}, [], set(), {}, {}, {}
    mtimes = None
    for u, user in enumerate(TQ_USERS):
        extra = ("--precache", "--gtif-cache", gcache) if u < 2 else ()
        proc, client, starts[user], logs = start_tagger(season, user, env, logdir, extra)
        try:
            if u == 0:
                cached = sorted(os.listdir(gcache))
                mtimes = {f: os.stat(os.path.join(gcache, f)).st_mtime_ns for f in cached}
            if u == 1 and {f: os.stat(os.path.join(gcache, f)).st_mtime_ns
                           for f in os.listdir(gcache)} != mtimes:
                fail("tagger --precache rewrote a cached GeoTIFF")
            t1 = time.time()
            d, s = tagger_session(season, user, client)
            session_s[user] = time.time() - t1
            dists += d
            sizes |= s
        finally:
            t1 = time.time()
            proc.terminate()
            proc.wait(timeout=60)
            stop_s[user] = time.time() - t1
        for k, v in client.ms.items():
            ms.setdefault(k, []).extend(v)
        with open(logs[1]) as f:
            trace = f.read()
        # every import of the tagger and of its precache workers (their
        # traces share the file, so only a tagger without workers is timed)
        bad = sorted({ln.split("|")[-1].strip() for ln in trace.splitlines()
                      if ln.startswith("import time:") and ln.split("|")[-1].strip().split(".")[0]
                      in ("torch", "jax", "jaxlib", "flax", "srcfinder_tpu")})
        if bad:
            fail(f"the tagger imported {bad[:10]}")
        if not extra:
            imports[user] = import_profile(trace)[0]["imports_s"]
    if max(dists) > 1.0:
        fail(f"tagger: an added candidate lies {max(dists)} px from its click's pixel")
    if [s for s in sizes if s[0] == "fit"] != [("fit", *tagger_png_size([0, 0, *SCENE[1::-1]],
                                                                          SCENE[1::-1]))]:
        fail(f"tagger: fitted PNG sizes {sorted(sizes)}")
    epsg = {f: geotiff_epsg(os.path.join(gcache, f)) for f in cached}
    if len(cached) != TQ_FLIGHTLINES or set(epsg.values()) != {3857}:
        fail(f"tagger --precache: {epsg}")
    prefix = os.path.join(root, "campaign")
    collect_s, _, procs = run_port_cli(["collect-qc", season["out"], "--lidfilters",
                                        season["lidfilters"], "--outprefix", prefix,
                                        "--auto-resolve", "m"], env)
    if any(m.split(".")[0] == "torch" for p in procs for m in p["modules"]):
        fail("collect-qc imported torch")
    merge = check_merge(season, prefix)
    modes = precache_modes([os.path.join(season["data"], n) for n in season["names"]], root)
    img = {k: float(np.median(ms["GET /img"][i::2])) for i, k in enumerate(("fit", "zoom"))}
    return dict(users=len(TQ_USERS), flightlines=TQ_FLIGHTLINES, candidates=TQ_CANDIDATES,
                scene=list(SCENE[:2]), setup_s=setup_s, start_s=starts, session_s=session_s,
                stop_s=stop_s,
                precache_s=starts[TQ_USERS[0]] - starts[TQ_USERS[2]],
                precache_in_process_s=modes,
                imports_s=imports, collect_qc_s=collect_s,
                collect_qc_imports_s=procs[0]["imports_s"], png_sizes=sorted(sizes),
                click_max_px=max(dists), img_ms=img, gtifs=len(cached),
                endpoint_ms={k: float(np.median(v)) for k, v in sorted(ms.items())},
                requests=sum(len(v) for v in ms.values()), merge=merge,
                check_s=time.time() - t_all)


def precache_modes(imgfs, root):
    """The tagger's precache of ``imgfs`` in this process, in turns: threads
    (precache_gtifs, 4 workers) and spawned processes (4, the port's
    workers before the native codec), each into a cache of its own.
    Returns the seconds of each run by mode."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from functools import partial
    from srcfinder_torch.qc.gtif import img_to_gtif, precache_gtifs
    out = {}
    for i, mode in enumerate(("threads", "processes", "processes", "threads")):
        cache = os.path.join(root, f"gtif_{mode}_{i}")
        t0 = time.time()
        if mode == "threads":
            precache_gtifs(imgfs, cache)
        else:
            with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
                list(pool.map(partial(img_to_gtif, outdir=cache), imgfs))
        out.setdefault(mode, []).append(time.time() - t0)
        shutil.rmtree(cache)
    return out


def phase_triage_qc(workdir):
    """CMF systematics triage and QC labelling (phase 4g): the COVID oracle
    at the reference's size on the card against the CPU, and one labelling
    season on the tagger merged by collect-qc, each console script a
    process of the port's dispatcher with every import traced. The hand
    kernels' counters are zeroed before and read after: none is on this
    path."""
    from srcfinder_torch.ops import loo, moments, trunk_fuse
    kernels = (moments.KERNEL, loo.KERNEL, trunk_fuse.KERNEL)
    for k in kernels:
        k.reset()
    t0 = time.time()
    root = os.path.join(workdir, "triage_qc")
    env = dict(os.environ, PYTHONPATH=HERE, PYTHONPROFILEIMPORTTIME="1")
    try:
        os.makedirs(os.path.join(root, "covid"))
        os.makedirs(os.path.join(root, "qc"))
        oracle = covid_oracle_check(os.path.join(root, "covid"), env)
        shutil.rmtree(os.path.join(root, "covid"), ignore_errors=True)
        season = tagger_season_check(os.path.join(root, "qc"), env)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        fail(f"triage_qc launched hand kernels: {launches}")
    print(json.dumps({"triage_qc": dict(covid_oracle=oracle, tagger=season,
                                        hand_kernel_launches=launches,
                                        phase_s=time.time() - t0)}))


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
    from srcfinder_torch.ops import eigh, loo, moments

    gen = torch.Generator(device="cuda").manual_seed(2802)
    t0 = time.time()
    rdn, _ = write_scene(workdir, gen, name="ang20200924t213000_rdn_v2y1_img", modes=True)
    setup_s = time.time() - t0
    nl, ns, _ = SCENE
    nblocks = -(-ns // C)

    # count the f64 gate's columns during the run
    calls = {"f64_columns": 0}
    f64_cols = tpl._f64_columns_multimodal

    def count_f64(xblk, cols, *a, **k):
        calls["f64_columns"] += len(cols)
        return f64_cols(xblk, cols, *a, **k)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    eigh.reset()
    tpl._f64_columns_multimodal = count_f64
    try:
        t0 = time.time()
        prods = run_flightline(rdn, libf, wf, os.path.join(workdir, "out_mm"), prob_thr=0.0,
                               do_ime=True, bgmodes=2, device="cuda",
                               progress=lambda msg: print(msg, flush=True))
        torch.cuda.synchronize()
        run_s = time.time() - t0
    finally:
        tpl._f64_columns_multimodal = f64_cols
    peak = torch.cuda.max_memory_allocated()
    launches = {"masked_moments": moments.KERNEL.launches, "loo_sweep": loo.KERNEL.launches,
                "syevj": eigh.launches()}
    if eigh.library_calls():
        fail(f"{eigh.library_calls()} eigensolves of the multimodal run took the library route")
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
                       syevj=launches["syevj"] / nblocks),
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
    of the trunk follows three convs (an f32 conv's weight split, launched
    just before it, is left out of the sequence)."""
    events = [e for e in events if "conv_tf32x3_kernel_split" not in e.name]
    kind = ["conv" if re.search(r"conv_(wgmma|tf32x3)_kernel", e.name)
            else "pool" if "maxpool_kernel" in e.name else "" for e in events]
    return sum(events[i].time_range.elapsed_us() + events[i + 1].time_range.elapsed_us()
               for i in range(3, len(events) - 1)
               if kind[i] == "pool" and kind[i - 3:i] == ["conv"] * 3
               and kind[i + 1] == "conv") / 1e3


# device functions by family: the first pattern a name matches; cuDNN's
# convolutions and its layout transposes are "cudnn_conv"
KERNEL_FAMILIES = (("front_kernel", r"front_kernel"), ("conv_wgmma_kernel", r"conv_wgmma_kernel"),
                   ("conv_tf32x3_kernel_split", r"conv_tf32x3_kernel_split"),
                   ("conv_tf32x3_kernel", r"conv_tf32x3_kernel"),
                   ("maxpool_kernel", r"maxpool_kernel"),
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
            k.update(trunk_bound(ops, k["bytes"], dname))
            k["share_of_bound"] = k["bound_ms"] / k["ms"]
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
    launch counters just before and reads them just after; a kernel route
    must have launched every conv of its segments' plans on the conv
    kernel of its dtype (conv_wgmma_kernel, conv_tf32x3_kernel) at the
    rule's tile widths (trunk_fuse.conv_launches), and both kernel routes'
    bf16 profiles must name conv_wgmma_kernel. Returns
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
        convs = {d: trunk_fuse.conv_launches(getattr(torch, d))
                 for d in ("bfloat16", "float32")}
        stats[tag] = dict(s=s, windows_per_s=n_win / s,
                          peak_mem_bytes=torch.cuda.max_memory_allocated(),
                          projected_full_scene_s=s * SCENE[0] / STRIP_LINES,
                          launches=counts, conv_launches=convs, route=trunk)
        launched = sorted(k for k, c in counts.items() if c > 0)
        if launched != sorted(ROUTE_KERNELS[trunk]):
            fail(f"{tag}: launched {launched}, trunk {trunk} launches "
                 f"{sorted(ROUTE_KERNELS[trunk])}")
        # every conv of the route's segments on the conv kernel of its
        # dtype, at the rule's widths; none in the other dtype
        dname = "bfloat16" if "bf16" in tag else "float32"
        want = {d: plan_conv_launches(counts, getattr(torch, d)) if d == dname else {}
                for d in convs}
        if convs != want:
            fail(f"{tag}: conv launches by dtype and tile width {convs}, its segments' "
                 f"plans launch {want}")
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
    for route, prof in (("segments", seg), ("stage12", s12)):
        if not prof["families_ms"].get("conv_wgmma_kernel"):
            fail(f"the {route} route's bf16 profile names no tensor-core conv kernel "
                 f"(conv_wgmma_kernel): {prof['top']}")
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
    # the windowed dilated pass, forced to DILATED_BLOCK, in f32 and bf16
    windows = []
    probs = tfp._dilated_probs
    tfp._dilated_probs = lambda m, c: windows.append(c.shape[0]) or probs(m, c)
    try:
        windowed = _timed(stats, f"dilated_f32_block{DILATED_BLOCK}",
                          lambda: tfp.fcn_dilated_saliency(model, x, block=DILATED_BLOCK))
        windowed16 = _timed(stats, f"dilated_bf16_block{DILATED_BLOCK}",
                            lambda: tfp.fcn_dilated_saliency(model16, x16, block=DILATED_BLOCK))
    finally:
        tfp._dilated_probs = probs
    jmodel = tfp.load_saliency_model(_jax_test_weights(workdir), device="cuda")
    jphase = tfp.fcn_phase_saliency(jmodel, x)
    jdilated = _timed(stats, "dilated_f32_jax_test_weights",
                      lambda: tfp.fcn_dilated_saliency(jmodel, x))

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()
    checks = {
        "blocked_vs_unblocked": (diff(blocked, unblocked), PATH_TOL),
        "bf16_vs_f32": (diff(bf16, phase), BF16_TOL),
        "batch_vs_single": (max(diff(batch[0], phase), diff(batch[1], phase)), PATH_TOL),
        "scan_vs_wide": (diff(scan, phase), PATH_TOL),
        "dilated_vs_phase_interior": (by_margin[DILATED_REACH], PATH_TOL),
        "dilated_bf16_vs_f32": (diff(dilated16, dilated), BF16_TOL),
        "dilated_windowed_vs_one_pass": (diff(windowed, dilated), PATH_TOL),
        "dilated_bf16_windowed_vs_one_pass": (diff(windowed16, dilated16), BF16_TOL),
        "dilated_vs_phase_jax_test_weights": (diff(jdilated, jphase), BF16_TOL)}
    saliency_std = {"trained_like": phase.std().item(), "jax_test_weights": jphase.std().item()}
    print(json.dumps({"fcn_paths": dict(
        band=list(band.shape), stats=stats,
        max_abs_diff={k: {"diff": d, "bound": t} for k, (d, t) in checks.items()},
        dilated_vs_phase=dict(max_abs_diff_past_edge_margin=by_margin,
                              worst_row_col=list(worst), interior_margin=DILATED_REACH),
        dilated_windows=dict(block=DILATED_BLOCK, window_lines=windows,
                             canvas=list(tfp._canvas(x, 32).shape),
                             window_px=tfp.DILATED_WINDOW_PX),
        saliency_std=saliency_std)}))
    for k, (d, t) in checks.items():
        if not d <= t:
            fail(f"fcn_paths {k}: max |diff| {d:.3g} > {t:g}")
    for k, v in saliency_std.items():
        if not v > 1e-3:
            fail(f"fcn_paths: the {k} saliency is near constant (std {v:.3g})")
    if len(windows) != 2 * DILATED_WINDOWS:
        fail(f"fcn_paths: the windowed dilated passes ran windows of {windows} lines, "
             f"not {DILATED_WINDOWS} each")
    for name, sal in (("blocked", blocked), ("bf16", bf16), ("batch", batch),
                      ("scan", scan), ("dilated", dilated), ("dilated_bf16", dilated16),
                      ("dilated_windowed", windowed), ("dilated_bf16_windowed", windowed16)):
        if not torch.isfinite(sal).all():
            fail(f"fcn_paths {name}: saliency not finite")
    # the one-pass dilated f32 pass's seconds per canvas pixel (phase 8's yardstick)
    return stats["dilated_f32"]["s"] / tfp._canvas(x, 32).numel()


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
    readers in turns: the old memmap fancy index, the port's DirectFile
    (its copies out of the file's mapping), and one ``pread`` per run per
    line (the JAX package's buffered path). Each read's result (the new
    readers return a transposed view) then becomes a contiguous (rows,
    samples, bands) array, the old reader's layout, and all must be
    byte-equal. Returns seconds per reader (the reads, and apart the
    conversions) and bytes read."""
    import numpy as np
    from srcfinder_torch.cmf.pipeline import RGB_BANDS, active_range_for_library
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.masks.cli import flightline_mask_config
    from srcfinder_torch.masks.sds import needed_bands
    img = open_envi(rdn + ".hdr")
    params, _, _, wl = flightline_mask_config(img, rdn)
    a0, a1 = active_range_for_library(libf)
    req = sorted(set(needed_bands(wl, params).tolist()) | {0} | set(range(a0 - 1, a1))
                 | set(RGB_BANDS))
    mapped = open_envi(rdn + ".hdr")
    fd = os.open(rdn, os.O_RDONLY)
    readers = {"memmap": lambda r0, r1: memmap_read_lines_bands(img, r0, r1, req),
               "mapped": lambda r0, r1: mapped.read_lines_bands(r0, r1, req),
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
                bytes=img.nrows * img.ncols * len(req) * img.dtype.itemsize, step=step)


def long_dilated(ppmm, sal, wf, cnn_weights, one_pass_s_per_px):
    """The dilated path over the whole 12,000-line CMF band through
    fcn_saliency_image (phase 8): in line windows, each one's lines, seconds
    and peak device memory recorded; with the run's weights against the
    run's blocked phase saliency, and with the trained-like weights against
    the blocked phase pass with them, both on the interior (DILATED_REACH
    from every edge). Returns (summary, {check: (diff, bound)})."""
    import numpy as np
    import torch
    from srcfinder_torch.detect import fcn_pipeline as tfp

    band = np.ascontiguousarray(ppmm)
    h, w = band.shape
    inner = (slice(DILATED_REACH, h - DILATED_REACH), slice(DILATED_REACH, w - DILATED_REACH))
    windows, seconds, maps = [], {}, {}
    probs = tfp._dilated_probs

    def timed_window(m, c):
        st = {}
        out = _timed(st, "w", lambda: probs(m, c))
        windows.append(dict(lines=c.shape[0], **st["w"]))
        return out

    def run(weights, method):
        model = tfp.load_saliency_model(weights, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        out = tfp.fcn_saliency_image(band, model, method=method).cpu().numpy()
        return out, time.time() - t0

    torch.cuda.empty_cache()
    tfp._dilated_probs = timed_window
    try:
        for tag, weights in (("run_weights", wf), ("trained_like", cnn_weights)):
            maps[tag], seconds[f"dilated_{tag}"] = run(weights, "dilated")
    finally:
        tfp._dilated_probs = probs
    blocked, seconds["phase_blocked_trained_like"] = run(cnn_weights, "phase-blocked")
    canvas_px = tfp._canvas(torch.empty(h, w, device="meta"), 32).numel()
    slowdown = seconds["dilated_trained_like"] / canvas_px / one_pass_s_per_px
    nodata = sal == -9999.0
    checks = {
        "dilated_vs_run_saliency_interior": (
            float(np.abs(maps["run_weights"][inner] - sal[inner]).max()), PATH_TOL),
        "dilated_vs_phase_blocked_trained_like_interior": (
            float(np.abs(maps["trained_like"][inner] - blocked[inner]).max()), PATH_TOL)}
    summary = dict(canvas_px=canvas_px, windows=windows, seconds=seconds,
                   s_per_canvas_px=seconds["dilated_trained_like"] / canvas_px,
                   one_pass_s_per_canvas_px=one_pass_s_per_px, slowdown=slowdown,
                   saliency_std={k: float(v[~nodata].std()) for k, v in maps.items()},
                   max_abs_diff={k: {"diff": d, "bound": t} for k, (d, t) in checks.items()})
    rows, cols = tfp._canvas(torch.empty(h, w, device="meta"), 32).shape
    block = tfp._dilated_block(rows, cols, 32)
    n = sum(max(r0, 17) < min(r0 + block, 17 + h) for r0 in range(0, rows, block))
    if len(windows) != 2 * n or len({wd["lines"] for wd in windows}) != 1:
        fail(f"long flightline: the dilated path ran windows {windows}, not 2 x {n}")
    if not max(wd["peak_mem_bytes"] for wd in windows) < CARD_BYTES:
        fail("long flightline: a dilated window peaked over the card's memory")
    if not slowdown < DILATED_SLOWDOWN:
        fail(f"long flightline: the windowed dilated pass is {slowdown:.2f}x slower per "
             f"canvas pixel than the one-pass 2801-line pass")
    for k, v in maps.items():
        if not np.array_equal(v == -9999.0, nodata) or not np.isfinite(v).all():
            fail(f"long flightline: the dilated map ({k}) is not finite or stamps nodata "
                 f"elsewhere than the run's saliency")
    if not summary["saliency_std"]["trained_like"] > 1e-3:
        fail("long flightline: the trained-like dilated saliency is near constant")
    return summary, checks


def phase_long_flightline(workdir, libf, wf, cnn_weights, one_pass_s_per_px):
    """A real-length flightline through run_flightline with the masks and
    IME (phase 8). Returns the K1/K2 checks at its chunk shape and the
    dilation kernel's launches by element."""
    import numpy as np
    import pandas as pd
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect import fcn_pipeline as tfp
    from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4
    from srcfinder_torch.flow.pipeline_cli import run_flightline
    from srcfinder_torch.masks.cli import masks_for_flightline
    from srcfinder_torch.ops import loo, moments, morph

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
    morph.KERNEL.reset()
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
    dilate_launches = morph.launches()

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
    # the CPU run's dilations by element: the launches the card's run owes
    dilate, cpu_dilations = morph.dilate, dict.fromkeys(morph.ELEMENTS, 0)

    def count_dilate(seeds, radius, element):
        cpu_dilations[element] += 1
        return dilate(seeds, radius, element)
    morph.dilate = count_dilate
    try:
        t0 = time.time()
        ref_name = masks_for_flightline(rdn + ".hdr", workdir, out_name="masks_cpu",
                                        device="cpu")
        cpu_masks_s = time.time() - t0
    finally:
        morph.dilate = dilate
    ref = open_envi(os.path.join(workdir, ref_name)).load()
    positives = {name: int((masks[..., i] > 0).sum())
                 for i, name in enumerate(("cloud", "specular", "flare", "dark"))}
    dilated, dilated_checks = long_dilated(ppmm, sal, wf, cnn_weights, one_pass_s_per_px)

    # the unblocked phase pass at the pixel ceiling: its peak device memory
    ceiling = tfp.MAX_UNBLOCKED_PX // ns // 32 * 32
    x = preprocess_ch4(torch.tensor(np.asarray(ppmm[:ceiling], np.float32), device="cuda"),
                       *norm_for_model("multi_64"))
    model = tfp.load_saliency_model(wf, device="cuda")
    stats = {}
    _timed(stats, f"unblocked_{ceiling}", lambda: tfp.fcn_phase_saliency(model, x))
    del x, model

    # the fused read+masks phase by part: the masks' spans, seconds summed
    # by name (the reads and taps run in the reader thread)
    masks_parts = {}
    for sp in prods["spans"]:
        if sp.name.startswith("masks."):
            masks_parts[sp.name] = masks_parts.get(sp.name, 0.0) + sp.seconds
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
        masks_parts=masks_parts, readers=readers,
        fcn_method="phase-blocked" if seen["blocked"] else "unblocked",
        fcn_windows=seen["windows"], dilated=dilated, peak_mem_bytes=peak, plume_z=float(z),
        plume_ppmm=float(plume), background_ppmm=float(bg), background_sd=float(bg_sd),
        n_candidates=len(pd.read_csv(prods["detections_csv"])),
        ime_rows=len(pd.read_csv(prods["ime_csv"])),
        mask_positives=positives, masks_equal_cpu=bool(np.array_equal(masks, ref)),
        cpu_masks_s=cpu_masks_s, launches=launches, dilate_launches=dilate_launches,
        cpu_dilations=cpu_dilations, pixel_ceiling=stats,
        kernels_L12000={k[0]: {f: v[f] for f in ("max_rel_err", "bit_identical", "ms",
                                                 "plain_ms", "bound_ms")}
                        for k, v in checks.items()})
    print(json.dumps({"long_flightline": summary}))
    if seen["blocked"] != 1 or [w["lines"] for w in seen["windows"]] != [5824] * 3:
        fail(f"the FCN ran {seen['blocked']} blocked passes over windows "
             f"{[w['lines'] for w in seen['windows']]}, not 3 windows of 5824 lines")
    if not peak < 80e9:
        fail(f"peak device memory {peak / 1e9:.1f} GB")
    for k, (d, t) in dilated_checks.items():
        if not d <= t:
            fail(f"long flightline {k}: max |diff| {d:.3g} > {t:g}")
    if not z > 10:
        fail(f"long flightline: plume z = {z:.1f}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the long flightline")
    if not all(dilate_launches.values()) or dilate_launches != cpu_dilations:
        fail(f"long flightline: the dilation kernel launched {dilate_launches}, "
             f"the CPU run dilated {cpu_dilations}")
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
    return checks, dilate_launches


# ---- detection post-processing (phase 4d) and the trainer (phase 4e) ----

TRAIN_TILES, TRAIN_SIDE, TRAIN_BATCH = 64, 256, 16     # srcfinder-train's crop, batch
TRAIN_ROWS = 48                    # train.csv; the other 16 tiles are test.csv
TRAIN_CAMPAIGN = "CalCH4_v8"
TRAIN_TIMED_STEPS = 12             # timed steps after TRAIN_WARMUP (median)
TRAIN_WARMUP = 3
# one SAM step on the card against the same step on the CPU (f32, TF32
# off, dropout 0), per tensor (updated parameters, BatchNorm running
# statistics, momentum buffers) by relative L2: within TRAIN_TOL of the
# card's f64 step, or no farther from it than TRAIN_RATIO times the CPU's
# f32 step (see sam_step_card_vs_cpu); the loss within TRAIN_TOL. At the
# trainer's init about half of the 492 tensors lie past TRAIN_TOL from the
# f64 step on either device; the card's largest ratio was 16.5 (fc.bias, a
# cancelling sum over the batch; an NVIDIA H100 80GB HBM3, 700.00 W, against
# its host CPU), and a wrong step puts a well-conditioned tensor ~1e5 times
# farther than the CPU
TRAIN_TOL = 1e-4
TRAIN_RATIO = 50.0
POST_TOL = 1e-5                    # filtdet's KDE, the downsampled raster


def write_campaign(root):
    """A seeded training campaign in the reference's layout: TRAIN_TILES
    uncompressed 256 x 256 x 4 f32 GeoTIFF tiles (the port's writer; CH4 in
    band 4, |N(0, 1)| x 200 ppm*m), labels 1 / 0 / -1 in turn, every
    positive with an elongated gaussian plume of 800-2000 ppm*m from a
    random source and heading; train.csv (the first TRAIN_ROWS), test.csv
    (the rest) and data_labels.csv (all)."""
    import numpy as np
    from srcfinder_torch.core.geotiff import write_geotiff
    cdir = os.path.join(root, TRAIN_CAMPAIGN, "tiles")
    os.makedirs(cdir)
    rng = np.random.default_rng(64)
    yy, xx = np.mgrid[:TRAIN_SIDE, :TRAIN_SIDE].astype(np.float32)
    rows = []
    for i in range(TRAIN_TILES):
        lab = 1 if i % 3 == 0 else (0 if i % 3 == 1 else -1)
        tile = (np.abs(rng.normal(size=(TRAIN_SIDE, TRAIN_SIDE, 4))) * 200).astype(np.float32)
        if lab == 1:
            cy, cx = rng.uniform(64, 192, 2)
            th, length = rng.uniform(0, np.pi), rng.uniform(20, 60)
            u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            v = (yy - cy) * np.cos(th) - (xx - cx) * np.sin(th)
            tile[..., 3] += (np.exp(-0.5 * ((u / length) ** 2 + (v / (0.3 * length)) ** 2))
                             * rng.uniform(800, 2000)).astype(np.float32)
        write_geotiff(os.path.join(cdir, f"t{i:02d}.tif"), tile)
        rows.append((f"tiles/t{i:02d}.tif", lab))
    for name, sel in (("train.csv", rows[:TRAIN_ROWS]), ("test.csv", rows[TRAIN_ROWS:]),
                      ("data_labels.csv", rows)):
        with open(os.path.join(root, TRAIN_CAMPAIGN, name), "w") as f:
            f.write("path,label\n")
            f.writelines(f"{p},{lab}\n" for p, lab in sel)
    return tile


def _rel_l2(a, b):
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def sam_step_card_vs_cpu(x, y, weights):
    """One SAM step (lr 1e-4, the CLI's first epoch) of the trainer's
    network (seed 0, dropout 0) from the same weights and batch, at
    aux_weight 0 and 0.3: in f32 on the card and on the CPU, and in f64 on
    the card as the reference. Each tensor's relative L2 distance (updated
    parameters, running statistics, momentum buffers) between card and
    CPU is reported; the gate holds the card's f32 step as close to the
    f64 step as the CPU's f32 step is (TRAIN_RATIO times its distance) or
    within TRAIN_TOL. Some gradients are cancellations: a BatchNorm bias
    whose channel the next BatchNorm recentres gets a gradient of edge and
    ReLU terms only, which two f32 summation orders can put tens of percent
    apart (an NVIDIA H100 against its host CPU: 0.67 for
    inception3a.branch3.0.bn.bias at 256 x 256, batch 16, where the CPU
    lies 0.66 from the f64 step)."""
    import torch
    from srcfinder_torch.models.googlenet import GoogLeNet
    from srcfinder_torch.train import sam
    start = GoogLeNet(num_classes=2, aux_logits=True,
                      generator=torch.Generator().manual_seed(0)).state_dict()
    out = {}
    for aux in (0.0, 0.3):
        runs = {}
        for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                 ("card_f64", "cuda", torch.float64)):
            model = GoogLeNet(num_classes=2, aux_logits=True, dropout=0.0, dropout_aux=0.0)
            model.load_state_dict(start)
            model.to(device=dev, dtype=dtype).train()
            opt = sam.make_inner_optimizer(model.parameters())
            step = sam.make_sam_train_step(
                model, opt, torch.tensor(weights, device=dev, dtype=dtype), aux_weight=aux)
            t0 = time.time()
            loss = float(step(x.to(device=dev, dtype=dtype), y.to(dev), 1e-4))
            secs = time.time() - t0
            tensors = {k: v.detach().cpu() for k, v in model.state_dict().items()
                       if not k.endswith("num_batches_tracked")}
            tensors.update({f"momentum:{k}": opt.state[p]["momentum_buffer"].cpu()
                            for k, p in model.named_parameters()})
            runs[name] = (loss, tensors, secs)
        card, cpu, ref = (runs[k][1] for k in ("card", "cpu", "card_f64"))
        rows, over = [], []
        for k in ref:
            e_card, e_cpu = _rel_l2(card[k], ref[k]), _rel_l2(cpu[k], ref[k])
            rows.append((_rel_l2(card[k], cpu[k]), e_card, e_cpu, k))
            if e_card > TRAIN_TOL and e_card > TRAIN_RATIO * e_cpu:
                over.append((k, e_card, e_cpu))
        loss_err = abs(runs["card"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
        past = [r for r in rows if r[1] > TRAIN_TOL]
        out[f"aux_weight_{aux}"] = dict(
            loss_card=runs["card"][0], loss_cpu=runs["cpu"][0], loss_f64=runs["card_f64"][0],
            loss_rel=loss_err, card_s=runs["card"][2], cpu_s=runs["cpu"][2],
            card_f64_s=runs["card_f64"][2], tensors=len(ref),
            card_cpu_within_tol=sum(r[0] <= TRAIN_TOL for r in rows),
            worst_card_cpu=sorted(rows, reverse=True)[:4],
            card_f64_past_tol=len(past),
            worst_ratio_past_tol=sorted(((r[1] / max(r[2], 1e-30), r[3]) for r in past),
                                        reverse=True)[:6])
        if over or not loss_err <= TRAIN_TOL:
            print(json.dumps({"train_card_vs_cpu": out}), flush=True)
            fail(f"SAM step card vs CPU (aux_weight {aux}): loss {loss_err}, farther than "
                 f"{TRAIN_RATIO}x the CPU from the f64 step: {over[:5]}")
    return out


def step_ms(step, x, y):
    """Median ms of ``step`` over TRAIN_TIMED_STEPS steps on one batch
    after TRAIN_WARMUP: between two CUDA events around each step, and on
    the host's clock around each call, which returns once the step's
    kernels are queued (a host-bound step reads about the same on both)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(TRAIN_WARMUP):
        step(x, y, 1e-4, gen)
    events, host = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        step(x, y, 1e-4, gen)
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in events)
    return ms[len(ms) // 2], sorted(host)[len(host) // 2]


def _epoch_times(outdir):
    with open(os.path.join(outdir, "epoch_times.csv")) as f:
        rows = list(csv.DictReader(f))
    return [{k: float(v) for k, v in r.items()} for r in rows]


def phase_train(workdir):
    """srcfinder-train's path at the reference's full width (phase 4e)."""
    import numpy as np
    import torch
    from srcfinder_torch.core.geotiff import read_geotiff, write_geotiff
    from srcfinder_torch.train import cli as train_cli
    from srcfinder_torch.train import sam
    from srcfinder_torch.train import train as ttrain
    from srcfinder_torch.ops import loo, moments, trunk_fuse
    from srcfinder_torch.train.data import (TRAIN_CAMPAIGN_NORM, TiledDataset, load_labels_csv,
                                            loss_weights_for)

    root = os.path.join(workdir, "train_data")
    t0 = time.time()
    last_tile = write_campaign(root)
    summary = dict(tiles=TRAIN_TILES, side=TRAIN_SIDE, batch=TRAIN_BATCH,
                   campaign_write_s=time.time() - t0)
    # the LZW codec on one tile, timed on its own
    lzw = os.path.join(workdir, "lzw_tile.tif")
    t0 = time.time()
    write_geotiff(lzw, last_tile, compress="lzw")
    summary["lzw_tile_write_s"] = time.time() - t0
    t0 = time.time()
    back, _ = read_geotiff(lzw)
    summary["lzw_tile_read_s"] = time.time() - t0
    if not np.array_equal(back, last_tile):
        fail("LZW tile read back differs")
    t0 = time.time()
    read_geotiff(os.path.join(root, TRAIN_CAMPAIGN, "tiles", "t63.tif"))
    summary["plain_tile_read_s"] = time.time() - t0

    # the CLI in this process: SAM, 2 epochs, its defaults otherwise
    captured = {}
    run_experiment = ttrain.train_experiment

    def keep(cfg, progress=print):
        captured["out"] = run_experiment(cfg, progress)
        return captured["out"]

    ttrain.train_experiment = keep
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in (moments.KERNEL, loo.KERNEL, trunk_fuse.KERNEL):
            k.reset()
        t0 = time.time()
        train_cli.main([root, TRAIN_CAMPAIGN, "--epochs", "2", "--augment", "augA",
                        "--outroot", os.path.join(workdir, "train_out")])
        torch.cuda.synchronize()
        summary["cli_s"] = time.time() - t0
        summary["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        # no hand kernel is on this path (cuDNN convolutions under autograd)
        summary["hand_kernel_launches"] = {k.name: k.launches for k in
                                           (moments.KERNEL, loo.KERNEL, trunk_fuse.KERNEL)}
        model, outdir, metrics = captured["out"]
        with open(os.path.join(outdir, "batch_losses.csv")) as f:
            losses = [float(r["loss"]) for r in csv.DictReader(f)]
        if len(losses) != 2 * (TRAIN_ROWS // TRAIN_BATCH) or not np.isfinite(losses).all():
            fail(f"batch losses {losses}")
        for name in ("epoch_losses.csv", "val_losses.csv", "epoch_times.csv", "metrics.json"):
            if not os.path.isfile(os.path.join(outdir, name)):
                fail(f"training wrote no {name}")
        weights = sorted(os.listdir(os.path.join(outdir, "weights")))
        if len(weights) != 1 or not weights[0].startswith("final_"):
            fail(f"weights after 2 epochs: {weights} (every 5th epoch and the final)")
        final = os.path.join(outdir, "weights", weights[0])
        reloaded = ttrain.load_into(ttrain.make_model(1, "cuda"), ttrain.load_checkpoint(final))
        got, ref = reloaded.state_dict(), model.state_dict()
        unequal = [k for k in ref if not k.endswith("num_batches_tracked")
                   and not torch.equal(got[k], ref[k])]
        if unequal:
            fail(f"final npz reloads unequal: {unequal[:5]}")
        summary.update(losses=losses, threshold=metrics["threshold"], f1=metrics["f1"],
                       epochs_augA=_epoch_times(outdir))

        # one epoch more from the final npz: epoch 4 of 5, so the
        # every-5-epochs npz is written; augC, the costliest host augment
        t0 = time.time()
        train_cli.main([root, TRAIN_CAMPAIGN, "--epochs", "5", "--start-epoch", "4",
                        "--augment", "augC", "--resume", final,
                        "--outroot", os.path.join(workdir, "train_resume")])
        torch.cuda.synchronize()
        summary["resume_s"] = time.time() - t0
        _, rdir, _ = captured["out"]
        rweights = sorted(os.listdir(os.path.join(rdir, "weights")))
        if len(rweights) != 2 or not rweights[0].startswith("4_"):
            fail(f"weights of the resumed epoch 4: {rweights}")
        summary["epochs_augC"] = _epoch_times(rdir)
    finally:
        ttrain.train_experiment = run_experiment

    # one SAM step on the card against the CPU, on the first batch
    rows = load_labels_csv(os.path.join(root, TRAIN_CAMPAIGN, "train.csv"))
    mean, std = TRAIN_CAMPAIGN_NORM[TRAIN_CAMPAIGN]
    ds = TiledDataset(os.path.join(root, TRAIN_CAMPAIGN), rows, mean, std, TRAIN_SIDE, "augA")
    images, labels = next(ds.batches(TRAIN_BATCH, shuffle=False))
    x = torch.from_numpy(images[..., 0])[:, None]
    y = torch.from_numpy(labels.astype(np.int64))
    class_w = loss_weights_for(rows)
    summary["card_vs_cpu"] = sam_step_card_vs_cpu(x, y, class_w)
    summary["tol"] = TRAIN_TOL

    # step times at batch 16 with the CLI's dropout, CUDA events
    xc, yc = x.cuda(), y.cuda()
    times, host = {}, {}
    for name, make in (("sam", sam.make_sam_train_step), ("sgd", sam.make_sgd_train_step)):
        model = ttrain.make_model(0, "cuda")
        opt = sam.make_inner_optimizer(model.parameters())
        times[name], host[name] = step_ms(make(model, opt, torch.tensor(class_w, device="cuda")),
                                          xc, yc)
    # operations of one forward/backward pass from the shapes (convolutions
    # and matrix products, FlopCounterMode on the meta device); a SAM step
    # is two passes, an SGD step one; bound at the f32 peak (TF32 off)
    from torch.utils.flop_counter import FlopCounterMode
    meta = ttrain.make_model(0, "cpu").to("meta")
    with FlopCounterMode(display=False) as counter:
        logits, aux2, aux1 = meta(torch.empty(TRAIN_BATCH, 1, TRAIN_SIDE, TRAIN_SIDE,
                                              device="meta"))
        (logits.sum() + aux2.sum() + aux1.sum()).backward()
    pass_flop = counter.get_total_flops()
    summary.update(sam_step_ms=times["sam"], sgd_step_ms=times["sgd"],
                   sam_host_ms=host["sam"], sgd_host_ms=host["sgd"],
                   torch_threads=torch.get_num_threads(), cpus=os.cpu_count(),
                   sam_images_per_s=TRAIN_BATCH / times["sam"] * 1e3,
                   sgd_images_per_s=TRAIN_BATCH / times["sgd"] * 1e3,
                   pass_gflop=pass_flop / 1e9,
                   sam_bound_ms=2 * pass_flop / PEAK_FLOPS["float32"] * 1e3,
                   sgd_bound_ms=pass_flop / PEAK_FLOPS["float32"] * 1e3)

    # the device's idle share over one epoch of the training loop, augA and augC
    prof = {}
    for aug in ("augA", "augC"):
        model = ttrain.make_model(0, "cuda")
        opt = sam.make_inner_optimizer(model.parameters())
        step = sam.make_sam_train_step(model, opt, torch.tensor(class_w, device="cuda"))
        epoch_ds = TiledDataset(os.path.join(root, TRAIN_CAMPAIGN), rows, mean, std,
                                TRAIN_SIDE, aug)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def epoch():
            for images, labels in epoch_ds.batches(TRAIN_BATCH):
                xb, yb = ttrain._to_device(images, labels, torch.device("cuda"))
                step(xb, yb, 1e-4, gen)

        epoch()                                  # warm-up: cuDNN's algorithm choice
        p = device_profile(epoch)
        prof[aug] = {k: p[k] for k in ("wall_ms", "device_busy_ms", "idle_share")}
        prof[aug]["top"] = p["top"][:6]
    summary["epoch_profile"] = prof
    print(json.dumps({"train": summary}))
    shutil.rmtree(root, ignore_errors=True)


def phase_postproc(workdir, cmf_product):
    """filtdet and the Gaussian downsampling on the scene's CMF band
    (phase 4d)."""
    import importlib
    import numpy as np
    import torch
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.core.geo import mapinfo
    from srcfinder_torch.detect import downsample_cli
    filtdet = importlib.import_module("srcfinder_torch.detect.filtdet")
    posthoc = importlib.import_module("srcfinder_torch.detect.posthoc_down")

    img = open_envi(cmf_product)
    band = np.asarray(img.read_band(3), np.float32)
    nodata = band == -9999.0
    out = dict(shape=list(band.shape))

    def timed(fn, dev):
        fn()                                      # warm-up (cuFFT / cuDNN plans)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        r = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        return r, (time.time() - t0) * 1e3

    res = {dev: timed(lambda d=dev: filtdet.filtdet(band, nodata, device=d), dev)
           for dev in ("cuda", "cpu")}
    (kc, cc), (kh, ch) = res["cuda"][0], res["cpu"][0]
    kde_cpu = filtdet.kde(band, device="cpu").numpy()
    kde_card = filtdet.kde(band, device="cuda").cpu().numpy()
    kde_err = float(np.abs(kde_card - kde_cpu).max() / np.abs(kde_cpu).max())
    det_err = float(np.abs(kc - kh).max() / (np.abs(kde_cpu).max()
                                             / (filtdet.MFMAX - filtdet.MFMIN)))
    if not (kde_err <= POST_TOL and det_err <= POST_TOL):
        fail(f"filtdet card vs CPU: kde {kde_err}, detkde {det_err} over {POST_TOL}")
    if not np.array_equal(cc, ch):
        fail("filtdet detcomp differs between card and CPU")
    kde_ms = cuda_ms(lambda: filtdet.kde(band, device="cuda"))
    out["filtdet"] = dict(card_ms=res["cuda"][1], cpu_ms=res["cpu"][1], kde_device_ms=kde_ms,
                          kde_err=kde_err, detkde_err=det_err, components=int(cc.max()),
                          detected_px=int((kc > 0).sum()), k=filtdet.KERNEL)

    src_res = float(mapinfo(img)["xps"])
    res = {dev: timed(lambda d=dev: posthoc.gaussian_downsample(
        band, src_res, 30.0, device=d).cpu().numpy(), dev) for dev in ("cuda", "cpu")}
    dc, dh = res["cuda"][0], res["cpu"][0]
    if dc.shape != dh.shape or not np.array_equal(dc == -9999.0, dh == -9999.0):
        fail("gaussian_downsample: shape or nodata cells differ between card and CPU")
    valid = dh != -9999.0
    down_err = float(np.abs(dc[valid] - dh[valid]).max() / np.abs(dh[valid]).max())
    if not down_err <= POST_TOL:
        fail(f"gaussian_downsample card vs CPU {down_err} over {POST_TOL}")
    out["downsample"] = dict(card_ms=res["cuda"][1], cpu_ms=res["cpu"][1], err=down_err,
                             src_res=src_res, shape=list(dc.shape),
                             nodata_cells=int((~valid).sum()))
    dst = os.path.join(workdir, "cmf_30m")
    t0 = time.time()
    downsample_cli.main([cmf_product, dst, "-r", "30", "--band", "4"])
    out["downsample_cli_s"] = time.time() - t0
    if open_envi(dst).load().shape[:2] != dc.shape:
        fail("downsample_cli product shape")
    out["tol"] = POST_TOL
    print(json.dumps({"postproc": out}))


# the multi-GPU phase (phase 9): shards per card when the machine has one
# card (four shards' working sets at once: the exact CNN's three batches of
# 4096 windows peak near 3 x 11.26 GB), ranks of the data-parallel trainer
MG_SHARDS_ONE_CARD = 4
MG_RANKS = 2
# the data-parallel f64 SAM step against the one-process f64 step, per
# tensor by relative L2 (parameters by their change): the bound of
# tests/test_torch_train_ddp.py, where 3 steps at batch 4 and crop 32 came
# within 1.2e-8; the loss within MG_LOSS_ATOL
MG_DP_TOL = 1e-7
MG_LOSS_ATOL = 1e-10
MG_TIMED_STEPS = 12                # timed data-parallel steps after TRAIN_WARMUP


def mg_mesh():
    """Every card where there are two or more, else MG_SHARDS_ONE_CARD
    shards on card 0; and the trainer's device argument for MG_RANKS
    ranks: one card each (NCCL) or both on card 0 (gloo)."""
    import torch
    from srcfinder_torch.parallel import make_mesh
    n = torch.cuda.device_count()
    if n >= 2:
        return make_mesh(n, "cuda"), "cuda"
    return make_mesh(device=["cuda:0"] * MG_SHARDS_ONE_CARD), "cuda:0"


def mg_timed(mesh, stats, tag, fn):
    """``fn()`` with every card of ``mesh`` synchronised before and after:
    seconds and each card's peak device memory into ``stats[tag]``."""
    import torch
    cards = sorted(set(mesh), key=lambda d: d.index)
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.time()
    out = fn()
    for d in cards:
        torch.cuda.synchronize(d)
    stats[tag] = dict(s=time.time() - t0, peak_mem_bytes={
        str(d): torch.cuda.max_memory_allocated(d) for d in cards})
    return out


def mg_alpha_check(got, ref, tol):
    """Sharded against single-device LOOCV: the same alpha index on every
    column, or nll minima within ``tol`` (relative) where the index
    differs. Returns the columns that picked another index."""
    diff = (got.alpha_index != ref.alpha_index).nonzero().flatten().tolist()
    for c in diff:
        mk, mr = got.nll[c].min().item(), ref.nll[c].min().item()
        if not abs(mk - mr) <= tol * abs(mr):
            fail(f"multigpu: column {c} picks alpha {got.alpha_index[c].item()} "
                 f"against {ref.alpha_index[c].item()}, minima {mk} / {mr}")
    return diff


def mg_dp_worker(rank, world, dev, root, outdir):
    """A rank of the data-parallel checks (chip_smoke's own worker, spawned
    by srcfinder_torch.train.ddp.spawn): one f64 SAM step (dropout 0) on
    its rows of the campaign's first global batch, rank 0 writing the state
    to ``outdir/dp_f64.npz``; then the f32 step at the CLI's dropout timed
    on CUDA events (median of MG_TIMED_STEPS after TRAIN_WARMUP), with its
    reductions and, on the same rows, without (the unwrapped model, this
    rank's rows alone), each rank writing ``outdir/dp_ms_<rank>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from srcfinder_torch.models.googlenet import BatchNorm2d, GoogLeNet
    from srcfinder_torch.train import ddp, sam
    from srcfinder_torch.train import train as ttrain
    x, y, w = mg_first_batch(root)
    xs, ys, group = ddp.shard_batch(x, y, rank, world)
    xs, ys = xs.to(dev), ys.to(dev)

    model = GoogLeNet(num_classes=2, aux_logits=True, dropout=0.0, dropout_aux=0.0,
                      generator=torch.Generator().manual_seed(0)).double().to(dev).train()
    opt = sam.make_inner_optimizer(model.parameters())
    step = sam.make_sam_train_step(ddp.wrap(model, dev), opt,
                                   torch.tensor(w, dtype=torch.float64, device=dev))
    loss = float(step(xs.double(), ys, 1e-4, None, group=group))
    if rank == 0:
        state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
        state.update({f"momentum:{k}": opt.state[p]["momentum_buffer"].cpu().numpy()
                      for k, p in model.named_parameters()})
        np.savez(os.path.join(outdir, "dp_f64.npz"), loss=loss, **state)
    del model, opt, step
    torch.cuda.empty_cache()

    model = ttrain.make_model(0, dev)
    wt = torch.tensor(w, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1 + rank)
    out = {}
    for tag, net, g in (("dp", ddp.wrap(model, dev), group), ("local", model, None)):
        step = sam.make_sam_train_step(net, sam.make_inner_optimizer(model.parameters()), wt)
        dist.barrier()                          # the ranks time the same variant at once
        for _ in range(TRAIN_WARMUP):
            step(xs, ys, 1e-4, gen, group=g)
        events, host = [], []
        for _ in range(MG_TIMED_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            step(xs, ys, 1e-4, gen, group=g)
            host.append((time.perf_counter() - t0) * 1e3)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize(dev)
        ms = sorted(a.elapsed_time(b) for a, b in events)
        out[f"{tag}_sam_step_ms"] = ms[len(ms) // 2]
        out[f"{tag}_sam_host_ms"] = sorted(host)[len(host) // 2]
        if tag == "dp":
            # where a data-parallel step's host time goes: two steps under
            # torch.profiler, the host ops with the most self time
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(2):
                    step(xs, ys, 1e-4, gen, group=g)
                torch.cuda.synchronize(dev)
            top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
            out["dp_step_host_top"] = [(e.key, e.count // 2, e.self_cpu_time_total / 2e3)
                                       for e in top]
    # one all-reduce's device time (CUDA events, mean of 50 after one): the
    # largest BatchNorm's sums (2 x 1024 f32), and the gradients' 28 MB
    for tag, numel in (("allreduce_8KB_us", 2 * 1024), ("allreduce_28MB_us", 7 * 2 ** 20)):
        t = torch.ones(numel, device=dev)
        dist.all_reduce(t)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        dist.barrier()
        a.record()
        for _ in range(50):
            dist.all_reduce(t)
        b.record()
        torch.cuda.synchronize(dev)
        out[tag] = a.elapsed_time(b) / 50 * 1e3
    # collectives of a SAM step: each BatchNorm's sums forward and backward
    # in both passes, and the loss's weight sums and value
    out["batchnorm_layers"] = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    out["rows"] = int(xs.shape[0])
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(outdir, f"dp_ms_{rank}.json"), "w") as f:
        json.dump(out, f)


def mg_first_batch(root):
    """The campaign's first global batch (augA, unshuffled) as NCHW f32 on
    the host, its labels and the class weights."""
    import numpy as np
    import torch
    from srcfinder_torch.train.data import (TRAIN_CAMPAIGN_NORM, TiledDataset,
                                            load_labels_csv, loss_weights_for)
    rows = load_labels_csv(os.path.join(root, TRAIN_CAMPAIGN, "train.csv"))
    mean, std = TRAIN_CAMPAIGN_NORM[TRAIN_CAMPAIGN]
    ds = TiledDataset(os.path.join(root, TRAIN_CAMPAIGN), rows, mean, std, TRAIN_SIDE, "augA")
    images, labels = next(ds.batches(TRAIN_BATCH, shuffle=False))
    return (torch.from_numpy(images[..., 0])[:, None],
            torch.from_numpy(labels.astype(np.int64)), loss_weights_for(rows))


def phase_multigpu(workdir, rdn, libf, cmf_product, strip, cnn_weights):
    """Phase 9: the sharded inference paths and data-parallel training
    (see the module docstring). Returns {kernel: sharded launches}."""
    import numpy as np
    import torch
    from srcfinder_torch.cmf import matched_filter as mfmod
    from srcfinder_torch.cmf.pipeline import active_range_for_library, load_library
    from srcfinder_torch.core.envi import open_envi
    from srcfinder_torch.detect import cnn_pipeline as tcp
    from srcfinder_torch.detect import fcn_pipeline as tfp
    from srcfinder_torch.detect.preprocess import norm_for_model, preprocess_ch4
    from srcfinder_torch.models.convert import load_weights
    from srcfinder_torch.models.googlenet import GoogLeNet, fold_inference
    from srcfinder_torch.ops import loo, moments, trunk_fuse
    from srcfinder_torch.parallel import shard_columns_mf
    from srcfinder_torch.train import cli as train_cli
    from srcfinder_torch.train import ddp
    from srcfinder_torch.train import train as ttrain

    t_phase = time.time()
    mesh, rank_device = mg_mesh()
    cards = torch.cuda.device_count()
    shards = len(mesh)
    summary = dict(cards=cards, shards=shards, mesh=[str(d) for d in mesh],
                   note=("one card: the shards share it, so this proves the sharding and "
                         "the gather, not a speed-up") if cards == 1 else
                   f"{cards} cards, one shard each")
    stats, launches = {}, {}
    torch.cuda.empty_cache()

    # --- the CMF: the scene's active cube in 256-column chunks, f32
    active = active_range_for_library(libf)
    abscf = torch.as_tensor(load_library(libf, active), dtype=torch.float32, device="cuda")
    alphas = torch.as_tensor(mfmod.default_alphas(), dtype=torch.float32, device="cuda")
    raw = open_envi(rdn).read_band_window(active[0] - 1, active[1])       # (L, AB, S)
    x_all = torch.from_numpy(np.ascontiguousarray(raw.transpose(0, 2, 1))).to("cuda")
    del raw
    chunks, widths = [], []                      # padded to C columns, as the CMF pads
    for c0 in range(0, SCENE[1], C):
        xj = x_all[:, c0:c0 + C]
        widths.append(xj.shape[1])
        if xj.shape[1] < C:
            xj = torch.cat([xj, xj.new_zeros(xj.shape[0], C - xj.shape[1], xj.shape[2])], 1)
        chunks.append((xj.contiguous(), mfmod.valid_mask(xj).float()))
    mfmod.matched_filter_columns(*chunks[0], abscf, alphas)  # warm-up: eigh, kernels, threads
    shard_columns_mf(mesh, *chunks[0], abscf, alphas)
    single = mg_timed(mesh, stats, "cmf_single", lambda: [
        mfmod.matched_filter_columns(xj, mj, abscf, alphas) for xj, mj in chunks])
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    sharded = mg_timed(mesh, stats, "cmf_sharded", lambda: [
        shard_columns_mf(mesh, xj, mj, abscf, alphas) for xj, mj in chunks])
    launches["masked_moments"] = (moments.KERNEL.launches, f"shard_columns_mf, {shards} shards "
                                  f"x {len(chunks)} chunks")
    launches["loo_sweep"] = (loo.KERNEL.launches, launches["masked_moments"][1])
    cmf_err, other_alpha = 0.0, 0
    for got, ref, wd in zip(sharded, single, widths):     # the scene's columns
        got, ref = (type(r)(*(f[:, :wd] if f.ndim == 2 and f.shape[0] == SCENE[0] else f[:wd]
                              for f in r)) for r in (got, ref))
        scale = ref.mf.abs().max().item()
        cmf_err = max(cmf_err, (got.mf - ref.mf).abs().max().item() / scale)
        other_alpha += len(mg_alpha_check(got, ref, TOL["float32"]))
    summary["cmf"] = dict(chunks=len(chunks), chunk=[L, C, B, A], max_rel_err=cmf_err,
                          tol=TOL["float32"], columns_other_alpha=other_alpha,
                          launches={k: launches[k][0] for k in ("masked_moments", "loo_sweep")})
    for k in ("masked_moments", "loo_sweep"):
        if launches[k][0] != shards * len(chunks):
            fail(f"multigpu: {k} launched {launches[k][0]} times in the sharded CMF, "
                 f"not {shards} shards x {len(chunks)} chunks")
    if not cmf_err <= TOL["float32"]:
        fail(f"multigpu: sharded CMF {cmf_err:.3g} of the maximum from the single call")

    # the multimodal chunk: the first chunk with two background modes
    xm = chunks[0][0].clone()
    xm[:SCENE[0] // 2] += MODE_OFFSET
    mm = mfmod.valid_mask(xm).float()
    mm_single = mg_timed(mesh, stats, "multimodal_single", lambda:
                         mfmod.matched_filter_columns_multimodal(xm, mm, abscf, alphas, bgmodes=2))
    moments.KERNEL.reset()
    loo.KERNEL.reset()
    mm_sharded = mg_timed(mesh, stats, "multimodal_sharded", lambda: shard_columns_mf(
        mesh, xm, mm, abscf, alphas, bgmodes=2))
    labels_differ = int((mm_sharded.labels != mm_single.labels).sum())
    mm_err = ((mm_sharded.mf - mm_single.mf).abs().max() / mm_single.mf.abs().max()).item()
    summary["multimodal"] = dict(labels_differ=labels_differ, max_rel_err=mm_err,
                                 launches={"masked_moments": moments.KERNEL.launches,
                                           "loo_sweep": loo.KERNEL.launches})
    if labels_differ:
        fail(f"multigpu: {labels_differ} sharded multimodal labels differ from the single call's")
    if not mm_err <= TOL["float32"]:
        fail(f"multigpu: sharded multimodal CMF {mm_err:.3g} of the maximum from the single call")
    del x_all, chunks, single, sharded, xm, mm, mm_single, mm_sharded
    torch.cuda.empty_cache()

    # --- the FCN phase pass on the CMF band, trained-like weights
    band = torch.tensor(np.asarray(open_envi(cmf_product).read_band(-1), np.float32),
                        device="cuda")
    x = preprocess_ch4(band, *norm_for_model("multi_64"))
    model = tfp.load_saliency_model(cnn_weights, device="cuda")
    tfp.fcn_phase_saliency(model, x)                          # warm-up: cuDNN's choices
    tfp.fcn_phase_saliency(model, x, mesh=mesh)
    fcn_single = mg_timed(mesh, stats, "fcn_single", lambda: tfp.fcn_phase_saliency(model, x))
    fcn_sharded = mg_timed(mesh, stats, "fcn_sharded",
                           lambda: tfp.fcn_phase_saliency(model, x, mesh=mesh))
    fcn_diff = (fcn_sharded - fcn_single).abs().max().item()
    summary["fcn"] = dict(band=list(band.shape), max_abs_diff=fcn_diff, tol=PATH_TOL,
                          saliency_std=fcn_single.std().item())
    if not fcn_diff <= PATH_TOL or not torch.isfinite(fcn_sharded).all():
        fail(f"multigpu: sharded FCN {fcn_diff:.3g} from the single call (> {PATH_TOL:g})")
    del band, x, model, fcn_single, fcn_sharded
    torch.cuda.empty_cache()

    # --- the exact CNN on the strip at the CLI's configuration
    sband = torch.as_tensor(np.asarray(open_envi(strip).read_band(0), np.float32), device="cuda")
    cnn = GoogLeNet(num_classes=2)
    cnn.load_state_dict(load_weights(cnn_weights))
    cnn = fold_inference(cnn.eval()).to(device="cuda", dtype=torch.bfloat16)
    xs = preprocess_ch4(sband.to(torch.bfloat16), *norm_for_model("COVID_QC"))
    # warm-up: a whole sharded call, so every card has loaded the kernels
    # and packed its weights before the timed one
    tcp.cnn_window_saliency_sharded(cnn, xs, mesh, batch=CLI_BATCH)
    # one batch of CLI_BATCH windows on one card: the host's ms to queue it
    # (the call returns once its launches are queued) against its device ms
    # (CUDA events); shards are threads of one process, so the host's part
    # of each batch holds the interpreter lock
    fwd = tcp._WindowForward(cnn, "stage12")
    padded = tcp.reference_pad(xs, WIN)
    idx = torch.arange(CLI_BATCH, device="cuda")
    origins = torch.stack([idx // xs.shape[1], idx % xs.shape[1]], dim=1)
    fwd(padded, origins, WIN)
    torch.cuda.synchronize()
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    t0 = time.perf_counter()
    fwd(padded, origins, WIN)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[1].record()
    torch.cuda.synchronize()
    batch_ms = dict(host_queue_ms=host_ms, device_ms=ev[0].elapsed_time(ev[1]))
    # the same batch on each shard at once, one thread each (run_shards):
    # each thread's start and end (s from the common start) and its card's
    # device ms, to show whether the shards overlap
    from srcfinder_torch.parallel import replicate, run_shards
    fwds = {d: tcp._WindowForward(m, "stage12") for d, m in replicate(cnn, mesh).items()}
    inputs = {d: (padded.to(d), origins.to(d)) for d in fwds}
    t_start = time.perf_counter()

    def one(i, dev):
        e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter() - t_start
        e[0].record()
        fwds[dev](*inputs[dev], WIN)
        e[1].record()
        torch.cuda.synchronize(dev)
        return [t0, time.perf_counter() - t_start, e[0].elapsed_time(e[1])]
    run_shards(mesh, one)                                  # warm-up
    t_start = time.perf_counter()
    batch_ms["concurrent_start_end_s_device_ms"] = run_shards(mesh, one)
    del fwds, inputs
    cnn_single = mg_timed(mesh, stats, "exact_cnn_single", lambda: tcp.cnn_window_saliency(
        cnn, xs, batch=CLI_BATCH, trunk="stage12"))
    trunk_fuse.KERNEL.reset()
    cnn_sharded = mg_timed(mesh, stats, "exact_cnn_sharded", lambda: tcp.cnn_window_saliency_sharded(
        cnn, xs, mesh, batch=CLI_BATCH, trunk="stage12"))
    counts = {k: trunk_fuse.launches(k) for k in TRUNK_KERNELS}
    for k in ROUTE_KERNELS["stage12"]:
        launches[k] = (counts[k], f"cnn_window_saliency_sharded, {shards} shards, "
                                  f"bf16 batch {CLI_BATCH}")
    equal = bool(torch.equal(cnn_sharded, cnn_single))
    summary["exact_cnn"] = dict(windows=int(xs.numel()), batch=CLI_BATCH, bit_equal=equal,
                                launches=counts, one_batch=batch_ms)
    launched = sorted(k for k, c in counts.items() if c > 0)
    if launched != sorted(ROUTE_KERNELS["stage12"]):
        fail(f"multigpu: the sharded exact CNN launched {launched}")
    if not equal:
        fail(f"multigpu: the sharded exact CNN differs from the single call by "
             f"{(cnn_sharded - cnn_single).abs().max().item():.3g}")
    del sband, cnn, xs, cnn_single, cnn_sharded, fwd, padded
    torch.cuda.empty_cache()

    # --- data-parallel training: MG_RANKS ranks, phase 4e's campaign
    root = os.path.join(workdir, "mg_train")
    write_campaign(root)
    dpdir = os.path.join(workdir, "mg_dp")
    os.makedirs(dpdir)
    devices = ddp.rank_devices(rank_device, MG_RANKS)
    t0 = time.time()
    backend = ddp.spawn(mg_dp_worker, MG_RANKS, rank_device, os.path.join(dpdir, "rdv"),
                        args=(root, dpdir))
    worker_s = time.time() - t0
    # the one-process f64 step on the same global batch
    from srcfinder_torch.train import sam
    xb, yb, w = mg_first_batch(root)
    ref = GoogLeNet(num_classes=2, aux_logits=True, dropout=0.0, dropout_aux=0.0,
                    generator=torch.Generator().manual_seed(0)).double().to("cuda").train()
    start = {k: v.clone() for k, v in ref.state_dict().items()}
    opt = sam.make_inner_optimizer(ref.parameters())
    ref_loss = float(sam.make_sam_train_step(ref, opt, torch.tensor(
        w, dtype=torch.float64, device="cuda"))(xb.cuda().double(), yb.cuda(), 1e-4))
    got = np.load(os.path.join(dpdir, "dp_f64.npz"))
    worst = []
    for k, v in ref.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = torch.from_numpy(got[k]), v.cpu()
        if "running" not in k:
            a, b = a - start[k].cpu(), b - start[k].cpu()
        worst.append((_rel_l2(a, b), k))
    for k, p in ref.named_parameters():
        worst.append((_rel_l2(torch.from_numpy(got[f"momentum:{k}"]),
                              opt.state[p]["momentum_buffer"]), f"momentum:{k}"))
    worst.sort(reverse=True)
    loss_err = abs(float(got["loss"]) - ref_loss)
    times = []
    for r in range(MG_RANKS):
        with open(os.path.join(dpdir, f"dp_ms_{r}.json")) as f:
            times.append(json.load(f))
    dp_ms = [t["dp_sam_step_ms"] for t in times]
    local_ms = [t["local_sam_step_ms"] for t in times]
    host_ms = {k: [t[f"{k}_sam_host_ms"] for t in times] for k in ("dp", "local")}
    # the CLI, one epoch, data-parallel
    captured = {}
    run_experiment = ttrain.train_experiment

    def keep(cfg, progress=print):
        captured["out"] = run_experiment(cfg, progress)
        return captured["out"]

    ttrain.train_experiment = keep
    try:
        t0 = time.time()
        rc = train_cli.main([root, TRAIN_CAMPAIGN, "--epochs", "1", "--augment", "augA",
                             "--devices", str(MG_RANKS), "--device", rank_device,
                             "--outroot", os.path.join(workdir, "mg_train_out")])
        cli_s = time.time() - t0
    finally:
        ttrain.train_experiment = run_experiment
    _, outdir, _ = captured["out"]
    listing = sorted(os.listdir(outdir))
    weights = sorted(os.listdir(os.path.join(outdir, "weights")))
    with open(os.path.join(outdir, "batch_losses.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    summary["ddp"] = dict(
        ranks=MG_RANKS, devices=[str(d) for d in devices], backend=backend,
        f64_step=dict(loss=ref_loss, loss_abs_err=loss_err, tol=MG_DP_TOL,
                      worst_tensors=worst[:4], tensors=len(worst)),
        f32_sam_step_ms_per_rank=dp_ms, f32_local_sam_step_ms_per_rank=local_ms,
        reduction_share=[(d - l) / d for d, l in zip(dp_ms, local_ms)],
        f32_sam_host_ms_per_rank=host_ms["dp"], f32_local_sam_host_ms_per_rank=host_ms["local"],
        dp_step_host_top_ms=times[0]["dp_step_host_top"],
        allreduce_8KB_us=[t["allreduce_8KB_us"] for t in times],
        allreduce_28MB_us=[t["allreduce_28MB_us"] for t in times],
        batchnorm_layers=times[0]["batchnorm_layers"],
        rows_per_rank=[t["rows"] for t in times],
        rank_peak_mem_bytes=[t["peak_mem_bytes"] for t in times],
        worker_s=worker_s, cli_s=cli_s, cli_files=listing, cli_weights=weights,
        cli_batch_losses=losses)
    shutil.rmtree(root, ignore_errors=True)
    summary["stats"] = stats
    summary["phase_s"] = time.time() - t_phase
    print(json.dumps({"multigpu": summary}), flush=True)
    if backend != ("nccl" if cards >= 2 else "gloo"):
        fail(f"multigpu: the trainer ran {backend} on {cards} cards")
    if not worst[0][0] <= MG_DP_TOL or not loss_err <= MG_LOSS_ATOL:
        fail(f"multigpu: the data-parallel f64 step is {worst[0]} from the one-process "
             f"step (loss {loss_err:.3g})")
    if rc != 0 or listing != ["batch_losses.csv", "epoch_losses.csv", "epoch_times.csv",
                              "metrics.json", "val_losses.csv", "weights"]:
        fail(f"multigpu: train.cli --devices {MG_RANKS} wrote {listing} (rc {rc})")
    if len(weights) != 1 or not weights[0].startswith("final_"):
        fail(f"multigpu: train.cli --devices {MG_RANKS} wrote weights {weights}")
    if len(losses) != TRAIN_ROWS // TRAIN_BATCH or not np.isfinite(losses).all():
        fail(f"multigpu: train.cli --devices {MG_RANKS} batch losses {losses}")
    return launches


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
    """Same-call A/B of the trunk kernels: ``python3 chip_smoke.py
    --trunk-times TREE`` times fused_stage12 (contiguous windows) of TREE's
    srcfinder_torch in each of TRUNK_CONFIGS, and trunk_s23, trunk_s3 and
    trunk_s45 in each of them too, on seeded windows, maps and weights
    (identical in every call), each beside its bound (trunk_bound: f32 as
    3xTF32) and with its error against TREE's plain version, and prints
    one JSON line. Run it on two trees in turns within
    one call (old, new, new, old)."""
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
    # each kernel's input: (side, channels) of its map, (B, D, D, 1) windows for P2
    inputs = {"fused_stage12": (WIN, 1), "trunk_s23": (WIN // 2, 64),
              "trunk_s3": (WIN // 8, 192), "trunk_s45": (WIN // 16, 480)}
    out = {}
    for dname, n in TRUNK_CONFIGS:
        dtype = getattr(torch, dname)
        for name in TRUNK_KERNELS:
            side, ch = inputs[name]
            p = tf.pack_params(name, seeded_params(gen, name, dtype))
            x = torch.randn(n, side, side, ch, generator=gen, device="cuda")
            x = (x if name == "fused_stage12" else x.relu_()).to(dtype)
            kern, plain = getattr(tf, name), getattr(tf, f"{name}_ref")
            with torch.no_grad():
                got, ref = kern(x, p), plain(x, p)
                rel = max_abs_diff(got, ref) / ref.float().abs().max().item()
                del got, ref
                ms = cuda_ms(lambda: kern(x, p), reps=20 if n < CLI_BATCH else 10)
            ops, n_in, n_out, n_w = trunk_work(name, n, WIN)
            bound = trunk_bound(ops, (n_in + n_out + n_w) * (torch.finfo(dtype).bits // 8), dname)
            out[f"{name} {dname}_b{n}"] = dict(ms=ms, **bound,
                                                share_of_bound=bound["bound_ms"] / ms,
                                                max_rel_err=rel)
            del x, p
            torch.cuda.empty_cache()
    print(json.dumps({"trunk_times": out, "tree": tree, "gpu": nvidia_smi_line()}))


def train_times(tree):
    """Same-call A/B of the one-card training step: ``python3 chip_smoke.py
    --train-times TREE`` times the SAM step of TREE's srcfinder_torch (the
    trainer's network, seed 0, at srcfinder-train's batch and crop) on a
    seeded batch with step_ms and prints one JSON line. Run it on two trees
    in turns within one call (old, new, new, old)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from srcfinder_torch.device import resolve_device
    from srcfinder_torch.train import sam
    from srcfinder_torch.train import train as ttrain
    if not ttrain.__file__.startswith(tree):
        fail(f"srcfinder_torch was not imported from {tree}")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(TRAIN_BATCH, 1, TRAIN_SIDE, TRAIN_SIDE, generator=gen, device="cuda")
    y = torch.arange(TRAIN_BATCH, device="cuda") % 2
    model = ttrain.make_model(0, "cuda")
    step = sam.make_sam_train_step(model, sam.make_inner_optimizer(model.parameters()),
                                   torch.tensor([1.0, 2.0], device="cuda"))
    ms, host = step_ms(step, x, y)
    print(json.dumps({"train_times": dict(sam_step_ms=ms, sam_host_ms=host), "tree": tree,
                      "gpu": nvidia_smi_line()}))


def multigpu_only():
    """``--multigpu``: phase 9 alone, after the build, on the main path's
    scene (its CMF and FCN run once through run_flightline)."""
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = nvidia_smi_line()
    print(smi)
    from srcfinder_torch.flow.pipeline_cli import run_flightline
    from srcfinder_torch.ops import build, loo, moments, trunk_fuse
    build.build_all((moments.KERNEL, loo.KERNEL, trunk_fuse.KERNEL))
    workdir = os.path.join(HERE, "chip_smoke_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        rdn, libf = write_scene(workdir, torch.Generator(device="cuda").manual_seed(2801))
        prods = run_flightline(rdn, libf, write_weights(workdir), os.path.join(workdir, "out"),
                               prob_thr=0.0, device="cuda", progress=lambda msg: None)
        launches = phase_multigpu(workdir, rdn, libf, prods["cmf"],
                                  write_strip(workdir, prods["cmf"]), write_cnn_weights(workdir))
        print(json.dumps({"sharded_launches": launches, "gpu": smi}))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--cmf-times":
        return cmf_times(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--trunk-times":
        return trunk_times(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--train-times":
        return train_times(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--multigpu":
        return multigpu_only()
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

    from srcfinder_torch.ops import build, eigh, loo, moments, morph, trunk_fuse
    built = (moments.KERNEL, loo.KERNEL, eigh.KERNEL, trunk_fuse.KERNEL, morph.KERNEL)
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
    for w in trunk_fuse.TILE_WIDTHS[torch.float32]:
        if not sass["trunk"].get(f"conv_tf32x3_kernel<float, {w}>", {}).get("HGMMA"):
            fail(f"no HGMMA instruction in the f32 conv (conv_tf32x3_kernel<float, {w}>)")
    for w in trunk_fuse.TILE_WIDTHS[torch.bfloat16]:
        if not sass["trunk"].get(f"conv_wgmma_kernel<bf16, {w}>", {}).get("HGMMA"):
            fail(f"no HGMMA instruction in the bf16 conv (conv_wgmma_kernel<bf16, {w}>)")
    if not sass["loo"].get("loo_kernel<double>", {}).get("DMMA"):
        fail("no DMMA instruction in the f64 LOOCV kernel (loo_kernel<double>)")

    phase_s = {}                               # each phase's seconds

    def timed(name, fn, *args):
        t = time.time()
        try:
            return fn(*args)
        finally:
            phase_s[name] = time.time() - t

    timed("conv_shapes", phase_conv_shapes)
    timed("stage12_layers", stage12_layers)
    checks = timed("kernels", phase_kernels)
    morph_stats = timed("morph", phase_morph)

    workdir = os.path.join(HERE, "chip_smoke_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        flightline, main_prods, rdn, libf = timed("main_path", phase_main_path, workdir)
        cmf_product = main_prods["cmf"]
        launches = {k: ("run_flightline", n) for k, n in flightline.items()}
        timed("native", phase_native, workdir, rdn, libf, main_prods)
        timed("postproc", phase_postproc, workdir, cmf_product)
        timed("train", phase_train, workdir)
        winds_launches = timed("winds", phase_winds, workdir, rdn, libf, cmf_product)
        timed("flow_stages", phase_flow_stages, workdir)
        timed("triage_qc", phase_triage_qc, workdir)
        mm_launches, mm_checks = timed("multimodal", phase_multimodal, workdir, libf,
                                       write_weights(workdir))
        checks.update(mm_checks)
        strip = write_strip(workdir, cmf_product)
        cnn_weights = write_cnn_weights(workdir)
        checks.update(timed("trunk_kernels", phase_trunk_kernels, strip, cnn_weights))
        launches.update(timed("exact_cnn", phase_exact_cnn, workdir, strip, cnn_weights))
        dilated_s_per_px = timed("fcn_paths", phase_fcn_paths, workdir, cmf_product,
                                 cnn_weights)
        mg_launches = timed("multigpu", phase_multigpu, workdir, rdn, libf, cmf_product, strip,
                            cnn_weights)
        for f in (rdn, rdn + ".hdr"):          # bound the disk use
            os.remove(f)
        long_checks, dilate_launches = timed("long_flightline", phase_long_flightline,
                                             workdir, libf, write_weights(workdir),
                                             cnn_weights, dilated_s_per_px)
        checks.update(long_checks)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"phase_seconds": phase_s}))

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
                         "gather_equal", "gather_ms", "bound_fma_ms", "share_of_bound")
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
            entry[c] = {k: v for k, v in checks[(kname, c)].items() if k in extra_keys}
            if c.startswith("multimodal"):
                # the launches of the multimodal run (phase 4b), from zero
                entry[c].update(launches=mm_launches[kname],
                                launches_in="run_flightline bgmodes=2")
        if kname in winds_launches:
            # the launches of the winds run (phase 4c), from zero
            entry["winds"] = dict(launches=winds_launches[kname],
                                  launches_in="pipeline_cli --watch --once --winds")
        if kname in mg_launches:
            # the launches of the sharded run (phase 9), from zero
            n, run = mg_launches[kname]
            entry["sharded"] = dict(launches=n, launches_in=run)
        kernels.append(entry)
    # the masks' dilation: its launches in phase 8's masked flightline by
    # element, its times and bound from phase 3a (the flare block's disk on
    # top, the cloud map's diamond nested)
    (top, top_stats), *others = morph_stats.items()
    kernels.append(dict(name="dilate", route="cuda", source="srcfinder_torch/ops/csrc/morph.cu",
                        replaces="none (host scipy)", launches=dilate_launches,
                        launches_in="run_flightline do_masks=True (12,000 lines)",
                        config=top, **top_stats, **dict(others)))
    # the eigensolve: its launches in the main path's flightline and the
    # multimodal run, its probe on one chunk's matrices (phase 3)
    kernels.append(dict(name="syevj", route="cuda", source="srcfinder_torch/ops/csrc/syevj.cu",
                        replaces="none (torch.linalg.eigh's cuSOLVER batched Jacobi; XLA's "
                                 "eigh in the JAX package)",
                        launches=launches["syevj"][1], launches_in="run_flightline",
                        config="float32", **checks[("syevj", "float32")]["cmf"],
                        float64=checks[("syevj", "float64")]["cmf"],
                        multimodal=dict(launches=mm_launches["syevj"],
                                        launches_in="run_flightline bgmodes=2")))
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
