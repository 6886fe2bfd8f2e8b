"""GoogLeNet trunk segments of the exact dense CNN: CUDA kernels + plain versions.

Three functions over a batch of windows, in the JAX package's NHWC layout,
with BN-folded weights (``models.googlenet.fold_state_dict``):

- :func:`fused_stage12`: (B, D, D, 1) windows -> conv1 -> ceil-pool ->
  conv2 -> conv3 -> ceil-pool -> (B, D/8, D/8, 192); D % 8 == 0.
- :func:`trunk_s23`: (B, h, h, 64) conv1 outputs -> ceil-pool -> conv2 ->
  conv3 -> ceil-pool -> inception3a/3b -> ceil-pool -> (B, h/8, h/8, 480);
  h % 16 == 0.
- :func:`trunk_s45`: (B, g, g, 480) -> inception4a..4e -> max-pool 2x2/2 ->
  inception5a/5b -> global average pool -> (B, 1024); g even.

For tensors on the CPU each runs its plain PyTorch version
(``*_ref``, built from ``F.conv2d``/``F.max_pool2d``); for CUDA tensors it
launches ``csrc/trunk.cu`` (built for ``sm_90a`` at first use) and raises
if it cannot. The kernels replace the JAX package's Pallas kernels
``ops/trunk_fuse.py::fused_stage12`` (git be3cd8d) and
``ops/trunk_fuse.py::fused_trunk_segment`` (git ca79403). Both versions
round where those did: f32 accumulation, bias and ReLU in f32, one rounding
to the input dtype after each conv; pools in the input dtype; the global
average pool a mean in f32.

Parameters come from :func:`stage12_params` and
:func:`trunk_segment_params` as flat lists in the Pallas kernels' layouts:
1x1 kernels (cin, cout), kxk kernels HWIO, biases (1, cout). Every
function takes such a list, or the same weights packed once for a device
and dtype by :func:`pack_params`, as a batch loop should pass them.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..models.googlenet import _ceil_maxpool
from .build import CudaKernel

__all__ = ["fused_stage12", "trunk_s23", "trunk_s45", "fused_stage12_ref",
           "trunk_s23_ref", "trunk_s45_ref", "stage12_params",
           "trunk_segment_params", "pack_params", "PackedParams", "launches",
           "KERNEL", "SCRATCH_BUDGET_BYTES"]

#: inception channel plans (reference: cnn/archs/googlenet1.py:64-79):
#: name -> (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj)
_INCEPTION = {
    "inception3a": (64, 96, 128, 16, 32, 32),
    "inception3b": (128, 128, 192, 32, 96, 64),
    "inception4a": (192, 96, 208, 16, 48, 64),
    "inception4b": (160, 112, 224, 24, 64, 64),
    "inception4c": (128, 128, 256, 24, 64, 64),
    "inception4d": (112, 144, 288, 32, 64, 64),
    "inception4e": (256, 160, 320, 32, 128, 128),
    "inception5a": (256, 160, 320, 32, 128, 128),
    "inception5b": (384, 192, 384, 48, 128, 128),
}
_BLOCKS = {"s23": ("inception3a", "inception3b"),
           "s45": ("inception4a", "inception4b", "inception4c", "inception4d",
                   "inception4e", "inception5a", "inception5b")}

#: Device scratch one call may hold; a larger batch runs as sub-batches.
#: At D = 256 a window needs 9.4 MB (stage 1+2) or 9.0 MB (s23) in f32 and
#: half that in bf16, so a 512-window f32 batch runs whole and the CLI's
#: 4096-window bf16 batch in three parts.
SCRATCH_BUDGET_BYTES = 8 << 30

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P, _P, _P, _P, _I, _I, _P]
_NAMES = ("fused_stage12", "trunk_s23", "trunk_s45")
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel("trunk.cu", {f"srcf_{n}_{s}": _SIG for n in _NAMES
                                 for s in _SUFFIX.values()})


def launches(name: str) -> int:
    """Launches of one of the three kernels (all dtypes) since the
    last ``KERNEL.reset()``."""
    return sum(KERNEL.counts[f"srcf_{name}_{s}"] for s in _SUFFIX.values())


# ---- parameters ----------------------------------------------------------

def _cin(name):
    """Input channels of an inception block."""
    names = list(_INCEPTION)
    i = names.index(name)
    if i == 0:
        return 192
    ch1, _, ch3, _, ch5, proj = _INCEPTION[names[i - 1]]
    return ch1 + ch3 + ch5 + proj


def _kb(sd, name):
    """(kernel HWIO, bias (1, cout)) of one folded conv of the port's
    state_dict (conv weights OIHW)."""
    if f"{name}.conv.bias" not in sd:
        raise ValueError("trunk kernels need BN-folded weights "
                         "(models.googlenet.fold_state_dict / fold_inference)")
    w = torch.as_tensor(sd[f"{name}.conv.weight"]).permute(2, 3, 1, 0)
    return w.contiguous(), torch.as_tensor(sd[f"{name}.conv.bias"]).reshape(1, -1)


def _inception_params(sd, name):
    """One block's folded weights as a flat list of 12, splitting a
    ``fused0`` wide 1x1 back into the three per-branch 1x1s: k1, b1, k2r,
    b2r, k2 (3x3), b2, k3r, b3r, k3 (3x3), b3, kp, bp."""
    ch1, red3, _, red5, _, _ = _INCEPTION[name]
    if f"{name}.fused0.conv.weight" in sd:
        k, b = _kb(sd, f"{name}.fused0")
        k = k.reshape(k.shape[2], -1)
        k1, k2r, k3r = torch.split(k, (ch1, red3, red5), dim=1)
        b1, b2r, b3r = torch.split(b, (ch1, red3, red5), dim=1)
    else:
        (k1, b1), (k2r, b2r), (k3r, b3r) = (
            _kb(sd, f"{name}.{br}") for br in ("branch1", "branch2.0", "branch3.0"))
        k1, k2r, k3r = (a.reshape(a.shape[2], -1) for a in (k1, k2r, k3r))
    k2, b2 = _kb(sd, f"{name}.branch2.1")     # 3x3 red3 -> ch3
    k3, b3 = _kb(sd, f"{name}.branch3.1")     # 3x3 red5 -> ch5 (torch quirk)
    kp, bp = _kb(sd, f"{name}.branch4.1")     # 1x1 cin -> proj
    kp = kp.reshape(kp.shape[2], -1)
    return [a.contiguous() for a in (k1, b1, k2r, b2r, k2, b2, k3r, b3r,
                                     k3, b3, kp, bp)]


def trunk_segment_params(sd, segment: str):
    """Flat weight list for :func:`trunk_s23` (``"s23"``) or
    :func:`trunk_s45` (``"s45"``) from the port's folded (optionally
    fused) ``state_dict``: s23 starts with conv2 (64, 64), its bias, conv3
    (3, 3, 64, 192) and its bias; then 12 per inception block."""
    if segment not in _BLOCKS:
        raise ValueError(f"unknown segment {segment!r}")
    out = []
    if segment == "s23":
        k2, b2 = _kb(sd, "conv2")
        k3, b3 = _kb(sd, "conv3")
        out = [k2.reshape(64, 64), b2, k3, b3]
    for name in _BLOCKS[segment]:
        out += _inception_params(sd, name)
    return out


def stage12_params(sd):
    """conv1 (49, 64), b1 (1, 64), conv2 (64, 64), b2 (1, 64), conv3
    (3, 3, 64, 192), b3 (1, 192) for :func:`fused_stage12` from the port's
    folded ``state_dict``."""
    (k1, b1), (k2, b2), (k3, b3) = (_kb(sd, n) for n in ("conv1", "conv2", "conv3"))
    return [k1.reshape(49, 64), b1, k2.reshape(64, 64), b2, k3, b3]


def _inception_shapes(name):
    ch1, red3, ch3, red5, ch5, proj = _INCEPTION[name]
    c = _cin(name)
    return [(c, ch1), (1, ch1), (c, red3), (1, red3), (3, 3, red3, ch3), (1, ch3),
            (c, red5), (1, red5), (3, 3, red5, ch5), (1, ch5), (c, proj), (1, proj)]


_SHAPES = {"fused_stage12": [(49, 64), (1, 64), (64, 64), (1, 64), (3, 3, 64, 192), (1, 192)],
           "trunk_s23": [(64, 64), (1, 64), (3, 3, 64, 192), (1, 192)]
           + _inception_shapes("inception3a") + _inception_shapes("inception3b"),
           "trunk_s45": sum((_inception_shapes(n) for n in _BLOCKS["s45"]), [])}


# ---- packing -----------------------------------------------------------------

class PackedParams:
    """One entry point's weights, shape-checked and laid out as both of
    its versions read them (from :func:`pack_params`): each inception's
    three 1x1s that read the block's input as one wide
    (cin, ch1 + red3 + red5) kernel and bias, so a block takes 8 tensors
    (wide k, wide b, k2, b2, k3, b3, kp, bp)."""

    def __init__(self, name, tensors):
        self.name, self.tensors = name, tensors


def pack_params(name, params, device=None, dtype=None) -> PackedParams:
    """Check ``params`` (from :func:`stage12_params` or
    :func:`trunk_segment_params`) against entry point ``name`` and pack
    them on ``device`` and ``dtype`` (default: where they are). Pass the
    result to the wrappers to pack once rather than on every call."""
    shapes = [tuple(p.shape) for p in params]
    if shapes != _SHAPES[name]:
        raise ValueError(f"{name}: weight shapes {shapes} != {_SHAPES[name]}")
    ps = [p.to(device=device or p.device, dtype=dtype or p.dtype).contiguous()
          for p in params]
    if name == "fused_stage12":
        return PackedParams(name, ps)
    head, blocks = (ps[:4], ps[4:]) if name == "trunk_s23" else ([], ps)
    for i in range(0, len(blocks), 12):
        k1, b1, k2r, b2r, k2, b2, k3r, b3r, k3, b3, kp, bp = blocks[i:i + 12]
        head += [torch.cat([k1, k2r, k3r], 1), torch.cat([b1, b2r, b3r], 1),
                 k2, b2, k3, b3, kp, bp]
    return PackedParams(name, head)


def _weights(name, params, x=None):
    """The packed tensors of ``params`` for entry point ``name``, packed
    here unless :func:`pack_params` did it; with ``x``, on its device and
    dtype."""
    if not isinstance(params, PackedParams):
        params = pack_params(name, params, *(() if x is None else (x.device, x.dtype)))
    if params.name != name:
        raise ValueError(f"{name}: weights packed for {params.name}")
    if x is not None and any((t.device, t.dtype) != (x.device, x.dtype)
                             for t in params.tensors):
        raise ValueError(f"{name}: weights packed for another device or dtype "
                         f"than the input's ({x.device}, {x.dtype})")
    return params.tensors


# ---- plain versions --------------------------------------------------------

def _conv_ref(x, k, b, stride=1, pad=0):
    """NCHW conv + bias + ReLU with a (cin, cout) or HWIO kernel."""
    if k.dim() == 2:
        k = k[None, None]
    w = k.to(device=x.device, dtype=x.dtype).permute(3, 2, 0, 1).contiguous()
    return F.relu(F.conv2d(x, w, b.reshape(-1).to(device=x.device, dtype=x.dtype),
                           stride, pad))


def _inception_ref(x, ws):
    """One inception block on NCHW ``x`` from its 8 packed tensors; the
    three 1x1s run as one wide conv, as the fused model and the kernel run
    them."""
    kw, bw, k2, b2, k3, b3, kp, bp = ws
    red3, red5 = k2.shape[2], k3.shape[2]
    o1, r2, r3 = torch.split(_conv_ref(x, kw, bw), (kw.shape[1] - red3 - red5, red3, red5),
                             dim=1)
    return torch.cat([o1, _conv_ref(r2, k2, b2, pad=1), _conv_ref(r3, k3, b3, pad=1),
                      _conv_ref(F.max_pool2d(x, 3, 1, 1), kp, bp)], dim=1)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def fused_stage12_ref(wins, params):
    """Plain version of :func:`fused_stage12`."""
    k1, b1, k2, b2, k3, b3 = _weights("fused_stage12", params)
    b, d = wins.shape[0], wins.shape[1]
    x = _conv_ref(wins.reshape(b, 1, d, d), k1.reshape(7, 7, 1, 64), b1, 2, 3)
    x = _conv_ref(_ceil_maxpool(x, 3, 2), k2, b2)
    x = _conv_ref(x, k3, b3, pad=1)
    return _nhwc(_ceil_maxpool(x, 3, 2))


def trunk_s23_ref(x, params):
    """Plain version of :func:`trunk_s23`."""
    ws = _weights("trunk_s23", params)
    k2, b2, k3, b3 = ws[:4]
    x = _conv_ref(_ceil_maxpool(_nchw(x), 3, 2), k2, b2)
    x = _ceil_maxpool(_conv_ref(x, k3, b3, pad=1), 3, 2)
    x = _inception_ref(_inception_ref(x, ws[4:12]), ws[12:20])
    return _nhwc(_ceil_maxpool(x, 3, 2))


def trunk_s45_ref(x, params):
    """Plain version of :func:`trunk_s45`."""
    ws = _weights("trunk_s45", params)
    x = _nchw(x)
    for i in range(5):
        x = _inception_ref(x, ws[8 * i:8 * (i + 1)])
    x = _ceil_maxpool(x, 2, 2)
    x = _inception_ref(_inception_ref(x, ws[40:48]), ws[48:56])
    return x.float().mean(dim=(2, 3)).to(x.dtype)


# ---- CUDA wrappers ---------------------------------------------------------

def _launch(name, x, out, weights, per_window, h):
    """Run entry point ``name`` over ``x`` in sub-batches that keep the
    scratch (``per_window``: NHWC shapes of one window's intermediates)
    within :data:`SCRATCH_BUDGET_BYTES`."""
    n = x.shape[0]
    window_bytes = sum(math.prod(s) for s in per_window) * x.element_size()
    sub = max(1, min(n, SCRATCH_BUDGET_BYTES // window_bytes))
    # scratch (and weights packed for this call alone) return to PyTorch's
    # caching allocator when this function ends; the allocator hands them
    # out again only to work queued later on the same stream, so the
    # kernels still read them safely
    scratch = [x.new_empty((sub,) + s) for s in per_window]
    wptr = (_P * len(weights))(*[t.data_ptr() for t in weights])
    sptr = (_P * len(scratch))(*[t.data_ptr() for t in scratch])
    fn = f"srcf_{name}_{_SUFFIX[x.dtype]}"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i in range(0, n, sub):
            k = min(sub, n - i)
            KERNEL.launch(fn, x[i:i + k].data_ptr(), out[i:i + k].data_ptr(),
                          ctypes.cast(wptr, _P), ctypes.cast(sptr, _P), k, h, stream)
    return out


def _check(name, x, channels):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[3] != channels:
        raise ValueError(f"{name}: expected (B, h, h, {channels}), got {tuple(x.shape)}")
    return x.contiguous()


def fused_stage12(wins, params):
    """(B, D, D, 1) windows -> (B, D/8, D/8, 192); ``params`` from
    :func:`stage12_params`. Plain version on the CPU, CUDA kernel on a card."""
    if wins.device.type == "cpu":
        return fused_stage12_ref(wins, params)
    wins = _check("fused_stage12", wins, 1)
    d = wins.shape[1]
    if d % 8:
        raise ValueError(f"fused_stage12: D % 8 == 0 required, got D = {d}")
    out = wins.new_empty((wins.shape[0], d // 8, d // 8, 192))
    return _launch("fused_stage12", wins, out, _weights("fused_stage12", params, wins),
                   [(d // 2, d // 2, 64), (d // 4, d // 4, 64), (d // 4, d // 4, 64),
                    (d // 4, d // 4, 192)], d)


def trunk_s23(x, params):
    """(B, h, h, 64) conv1 outputs -> (B, h/8, h/8, 480); ``params`` from
    :func:`trunk_segment_params` (``"s23"``). Plain version on the CPU,
    CUDA kernel on a card."""
    if x.device.type == "cpu":
        return trunk_s23_ref(x, params)
    x = _check("trunk_s23", x, 64)
    h = x.shape[1]
    if h % 16:
        raise ValueError(f"trunk_s23: h % 16 == 0 required, got h = {h}")
    h2, h4 = h // 2, h // 4
    out = x.new_empty((x.shape[0], h // 8, h // 8, 480))
    return _launch("trunk_s23", x, out, _weights("trunk_s23", params, x),
                   [(h2, h2, 64), (h2, h2, 64), (h2, h2, 192), (h4, h4, 192),
                    (h4, h4, 160), (h4, h4, 256), (h4, h4, 480)], h)


def trunk_s45(x, params):
    """(B, g, g, 480) -> (B, 1024) global-average-pooled trunk features
    (apply the fc head outside); ``params`` from
    :func:`trunk_segment_params` (``"s45"``). Plain version on the CPU,
    CUDA kernel on a card."""
    if x.device.type == "cpu":
        return trunk_s45_ref(x, params)
    x = _check("trunk_s45", x, 480)
    g = x.shape[1]
    if g % 2:
        raise ValueError(f"trunk_s45: even g required, got g = {g}")
    out = x.new_empty((x.shape[0], 1024))
    return _launch("trunk_s45", x, out, _weights("trunk_s45", params, x),
                   [(g, g, 240), (g, g, 832), (g, g, 832)], g)
