"""Frozen counts of the work the benchmark's cells ask for, and the H100's
peaks they are held to. They read the same work whatever implements it.

Peaks: NVIDIA's data sheet for the H100 SXM, dense. float32 work is taken at
the TF32 tensor rate, the highest at which the card takes f32 operands, so no
f32 implementation can read over 100%; the CMF kernels K1 and K2 are held to
the 67 TFLOP/s of the FMA and FP64 pipes, as the kernel table has them. Bytes at
HBM3's 3.35 TB/s, each input byte read once and each output byte written once.
"""

from __future__ import annotations

import functools
import math

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12, "float64": 67e12}
PEAK_CMF_KERNELS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4, "float64": 8}


def roofline_s(ops: float, nbytes: float, peak_flops: float) -> float:
    """Least seconds the card could take: the larger of the two bounds."""
    return max(ops / peak_flops, nbytes / PEAK_BYTES)


def _counted(fn, *shape):
    from torch.utils.flop_counter import FlopCounterMode
    from ..reference.googlenet import GoogLeNet1ch
    with torch.device("meta"):
        model = GoogLeNet1ch()
        x = torch.empty(*shape)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(model, x)
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def window_flops(dim: int = 256) -> int:
    """FLOPs of one window's class-1 probability (trunk, pool, fc) by
    FlopCounterMode over the plain GoogLeNet-1ch on the meta device."""
    return _counted(lambda m, x: m.probability(x), 1, 1, dim, dim)


@functools.lru_cache(maxsize=None)
def trunk_flops(dim: int = 256) -> int:
    """FLOPs of one window's trunk, conv1 through inception5b."""
    return _counted(lambda m, x: m.features(x), 1, 1, dim, dim)


def trunk_weight_elems() -> int:
    from ..reference.googlenet import GoogLeNet1ch
    with torch.device("meta"):
        m = GoogLeNet1ch()
    return sum(p.numel() for n, p in m.named_parameters() if not n.startswith("fc."))


def trunk_bound_s(windows: int, dim: int, dtype: str, batches: int) -> float:
    """Roofline of the trunk over ``windows`` windows in ``batches`` launches
    of the trunk: window in, 1024 x (dim/32)^2 features out, the weights
    once per batch."""
    nbytes = ITEMSIZE[dtype] * (windows * (dim * dim + 1024 * (dim // 32) ** 2)
                                + batches * trunk_weight_elems())
    return roofline_s(windows * trunk_flops(dim), nbytes, PEAK_FLOPS[dtype])


def canvas_shape(lines: int, samples: int, scale: int = 32) -> tuple:
    """The FCN's canvas: the scene padded to the next multiple of ``scale``
    (a whole ``scale`` more when already one, as the reference pads), then
    ``scale`` more on each side."""
    return (lines + scale - lines % scale + 2 * scale,
            samples + scale - samples % scale + 2 * scale)


@functools.lru_cache(maxsize=None)
def fcn_dense_flops(lines: int, samples: int) -> int:
    """One dense (a-trous, stride-1) trunk pass over the canvas plus the fc
    at every canvas pixel: the dense saliency the phase pass computes."""
    h, w = canvas_shape(lines, samples)
    return _counted(lambda m, x: m._head(m.dense_features(x), lambda t: t), 1, 1, h, w)


def k1_work(L: int, C: int, B: int, itemsize: int) -> tuple:
    """(operations, bytes) of K1, the masked moments of one (L, C, B) chunk:
    B(B+1)/2 multiply-adds per line for the symmetric S, 4 operations per
    element for the mean pass and the centring, one per line for the count;
    the cube and mask in, n, mu and S out."""
    ops = L * C * B * (B + 1) + 4 * L * C * B + L * C
    return ops, itemsize * (L * C * B + L * C + C + C * B + C * B * B)


def k2_work(L: int, C: int, B: int, A: int, itemsize: int) -> tuple:
    """(operations, bytes) of K2, the LOOCV sweep of one chunk over A
    alphas: r = sum_b z^2 / g (2 per band and alpha), then q, log q + r / q,
    the flag and the masked line sum (7 per line and alpha); Z, 1/g, beta
    and the mask in, the sums and flags out."""
    ops = 2 * L * C * B * A + 7 * L * C * A
    nbytes = itemsize * (L * C * B + C * B * A + C * A + L * C + C * A) + C * A
    return ops, nbytes


def eigh_nominal_ops(C: int, B: int) -> int:
    """A symmetric eigensolve with vectors, nominally 9 B^3 operations per
    matrix (tridiagonal reduction, QR sweeps, back-transform; Golub and Van
    Loan, 4th ed., sec. 8.3), over C matrices."""
    return 9 * C * B ** 3


def cmf_chunk_ops(L: int, C: int, B: int, A: int) -> int:
    """Operations of one CMF column chunk: K1, the eigensolve, the
    whitening Z = (x - mu) D^-1 V (2 L B^2 per column), K2 and the apply
    (2 L B per column)."""
    return (k1_work(L, C, B, 4)[0] + eigh_nominal_ops(C, B) + 2 * L * C * B * B
            + k2_work(L, C, B, A, 4)[0] + 2 * L * C * B)


def flightline_time_at_peak_s(cfg: dict, traffic: dict) -> float:
    """Seconds one flightline's counted work would take at the card's peak:
    the CMF's column chunks (the last padded to a whole chunk, as the
    program runs it) and the dense FCN pass, each at its precision's peak."""
    chunk = traffic["col_chunk"]
    chunks = math.ceil(cfg["samples"] / chunk)
    B = cfg["active_bands"][1] - cfg["active_bands"][0] + 1
    cmf = chunks * cmf_chunk_ops(cfg["lines"], chunk, B, cfg["alphas"])
    fcn = fcn_dense_flops(cfg["lines"], cfg["samples"])
    return cmf / PEAK_FLOPS[traffic["cmf_dtype"]] + fcn / PEAK_FLOPS[traffic["fcn_dtype"]]
