"""The whole flightline's share of the card's peak: the seconds its counted
work (the CMF's column chunks and one dense FCN pass over the canvas, each at
its precision's peak) would take, over ``flightline_s``."""

from portbench.counts.work import flightline_time_at_peak_s


def read(run):
    ideal = flightline_time_at_peak_s(run.ctx.cfg, run.ctx.traffic)
    return 100.0 * ideal / run.end_to_end["flightline_s"]
