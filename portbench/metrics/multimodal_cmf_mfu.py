"""The multimodal CMF product's share of the card's peak: the seconds its
counted work (per column chunk the PCA, one nominal eigh, the k-means and
K unimodal fits, at f32's TF32 peak) would take, over ``flightline_s``."""

from portbench.counts.multimodal import product_time_at_peak_s


def read(run):
    return 100.0 * product_time_at_peak_s(run.ctx.cfg, run.ctx.traffic) \
        / run.end_to_end["flightline_s"]
