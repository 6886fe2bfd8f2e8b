"""Plain GoogLeNet-1ch (Szegedy et al. 2015, arXiv:1409.4842) for the
benchmark's checks and counts.

The network of the reference ``cnn/archs.py`` ``googlenet1``: one input
channel, two classes, BasicConv2d = conv(bias=False) + BatchNorm(eps=1e-3)
+ ReLU, inception branch 3 with a 3x3 kernel (torchvision's weight-compatible
quirk), ceil-mode max pools. Parameter names are the reference checkpoint's,
so a ``state_dict`` of this module is a ``.pt`` checkpoint any caller of
that layout loads.

Plain ``torch.nn.functional`` calls only, in float32 with TF32 off. Every
convolution and the head's linear layer take their operands through
``rounding`` (the identity by default): :func:`bf16_round` gives the
reference's own gap at a cell's bfloat16, :func:`tf32_round` and
:func:`fp8_round` give the controls a precision one step below the
configuration's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

# (cin, 1x1, 3x3 reduce, 3x3, "5x5" reduce, "5x5", pool proj)
INCEPTION = {
    "inception3a": (192, 64, 96, 128, 16, 32, 32),
    "inception3b": (256, 128, 128, 192, 32, 96, 64),
    "inception4a": (480, 192, 96, 208, 16, 48, 64),
    "inception4b": (512, 160, 112, 224, 24, 64, 64),
    "inception4c": (512, 128, 128, 256, 24, 64, 64),
    "inception4d": (512, 112, 144, 288, 32, 64, 64),
    "inception4e": (528, 256, 160, 320, 32, 128, 128),
    "inception5a": (832, 256, 160, 320, 32, 128, 128),
    "inception5b": (832, 384, 192, 384, 48, 128, 128),
}


def identity(t):
    return t


def bf16_round(t):
    """Round float32 operands to bfloat16 (to nearest even), as a bfloat16
    path stores them, and back to float32."""
    return t.float().to(torch.bfloat16).float()


def tf32_round(t):
    """Round float32 operands to TF32 (10 explicit mantissa bits, to
    nearest, ties away), as the tensor cores read them."""
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def fp8_round(t):
    """Quantise operands to float8 e4m3 with one scale per tensor (its
    largest magnitude at 448, the format's largest), as an fp8 inference
    path stores them, and back to float32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x, rounding=identity, dilation=1, stride_one=False):
        c = self.conv
        x = F.conv2d(rounding(x), rounding(c.weight), None,
                     1 if stride_one else c.stride, c.padding[0] * dilation, dilation)
        x = F.batch_norm(x, self.bn.running_mean, self.bn.running_var, self.bn.weight,
                         self.bn.bias, False, 0.0, self.bn.eps)
        return F.relu(x)


class Inception(nn.Module):
    def __init__(self, cin, ch1, red3, ch3, red5, ch5, proj):
        super().__init__()
        self.branch1 = BasicConv2d(cin, ch1)
        self.branch2 = nn.Sequential(BasicConv2d(cin, red3), BasicConv2d(red3, ch3, 3, padding=1))
        self.branch3 = nn.Sequential(BasicConv2d(cin, red5), BasicConv2d(red5, ch5, 3, padding=1))
        self.branch4 = nn.Sequential(nn.MaxPool2d(3, 1, 1, ceil_mode=True), BasicConv2d(cin, proj))

    def forward(self, x, rounding=identity, dilation=1):
        b1 = self.branch1(x, rounding)
        b2 = self.branch2[1](self.branch2[0](x, rounding), rounding, dilation)
        b3 = self.branch3[1](self.branch3[0](x, rounding), rounding, dilation)
        if dilation == 1:
            pooled = F.max_pool2d(x, 3, 1, 1, ceil_mode=True)
        else:
            pooled = F.max_pool2d(F.pad(x, (dilation,) * 4, value=-float("inf")), 3, 1,
                                  dilation=dilation)
        return torch.cat([b1, b2, b3, self.branch4[1](pooled, rounding)], dim=1)


class GoogLeNet1ch(nn.Module):
    """Inference network: ``probability(x)`` gives each window's class-1
    probability, ``fcn_probability(x)`` the fc head applied at every
    position of the stride-32 features (the FCN), ``dense_features(x)``
    the stride-1 (a-trous) trunk used to count the FCN's work."""

    def __init__(self):
        super().__init__()
        self.conv1 = BasicConv2d(1, 64, 7, stride=2, padding=3)
        self.conv2 = BasicConv2d(64, 64)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        for name, shape in INCEPTION.items():
            setattr(self, name, Inception(*shape))
        self.fc = nn.Linear(1024, 2)

    def features(self, x, rounding=identity):
        x = self.conv1(x, rounding)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self.conv3(self.conv2(x, rounding), rounding)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self.inception3b(self.inception3a(x, rounding), rounding)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for name in ("inception4a", "inception4b", "inception4c", "inception4d", "inception4e"):
            x = getattr(self, name)(x, rounding)
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return self.inception5b(self.inception5a(x, rounding), rounding)

    def dense_features(self, x):
        """Every stride-2 step at stride 1, later kernels dilated by the
        stride removed so far: the trunk at full resolution."""
        def pool(t, k, d):
            return F.max_pool2d(F.pad(t, (0, (k - 1) * d, 0, (k - 1) * d), value=-float("inf")),
                                k, 1, dilation=d)
        x = pool(self.conv1(x, stride_one=True), 3, 2)
        x = pool(self.conv3(self.conv2(x), dilation=4), 3, 4)
        x = pool(self.inception3b(self.inception3a(x, dilation=8), dilation=8), 3, 8)
        for name in ("inception4a", "inception4b", "inception4c", "inception4d", "inception4e"):
            x = getattr(self, name)(x, dilation=16)
        x = pool(x, 2, 16)
        return self.inception5b(self.inception5a(x, dilation=32), dilation=32)

    def _head(self, feats, rounding):
        """(N, 1024, ...) features, channels first -> class-1 probability."""
        f = feats.movedim(1, -1)
        logits = F.linear(rounding(f), rounding(self.fc.weight), self.fc.bias)
        return torch.softmax(logits, dim=-1)[..., 1]

    def probability(self, x, rounding=identity):
        """(N, 1, D, D) windows -> (N,) class-1 probability."""
        return self._head(self.features(x, rounding).mean(dim=(2, 3)), rounding)

    def fcn_probability(self, x, rounding=identity):
        """(N, 1, H, W) -> (N, H', W') class-1 probability per stride-32 position."""
        return self._head(self.features(x, rounding), rounding)
