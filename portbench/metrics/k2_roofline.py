"""K2's share of its roofline: the bound of the window's nominal launches of
the LOOCV sweep at the chunk's shape (201 alphas) over the device time of
its kernels (``ops/csrc/loo.cu``)."""

from portbench.counts.cmf_kernels import kernel_share


def read(run):
    return kernel_share(run, "k2", r"loo_kernel|loo_combine_kernel")
