"""The exact CNN's share of the cards' peak: the windows done times
FlopCounterMode's operations per window, over the window's seconds times the
dtype's peak times the cards."""

from portbench.counts.work import PEAK_FLOPS, window_flops


def read(run):
    t, c = run.ctx.traffic, run.ctx.cfg
    return 100.0 * run.layer["windows"] * window_flops(c["dim"]) / (
        run.window_s * PEAK_FLOPS[t["dtype"]] * run.ctx.chips)
