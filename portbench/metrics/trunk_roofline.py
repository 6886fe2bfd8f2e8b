"""The trunk kernels' share of their roofline: the bound of the trunk work of
the windows done (FlopCounterMode's trunk operations per window at the
dtype's peak, or the windows, features and weights at 3.35 TB/s) over the
device time of the trunk library's kernels (``ops/csrc/trunk.cu``), summed
over the cards."""

from portbench.counts.work import trunk_bound_s

TRUNK_KERNELS = r"front_kernel|conv_wgmma_kernel|conv_tf32x3_kernel|maxpool_kernel|gap_kernel"


def read(run):
    if run.trace is None:
        return None
    s = run.trace.matching_s(TRUNK_KERNELS)
    if s <= 0:
        return None
    t = run.ctx.traffic
    bound = trunk_bound_s(run.layer["windows"], run.ctx.cfg["dim"], t["dtype"],
                          run.layer["batches"])
    return 100.0 * bound / s
