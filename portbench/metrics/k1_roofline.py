"""K1's share of its roofline: the bound of the window's nominal launches
(one per column chunk of every flightline, at the chunk's shape; f32 and f64
operations at 67 TFLOP/s, bytes at 3.35 TB/s) over the device time of the
masked-moments kernels (``ops/csrc/moments.cu``)."""

from portbench.counts.cmf_kernels import kernel_share


def read(run):
    return kernel_share(run, "k1", r"moments_(sum|scatter|combine)_kernel")
