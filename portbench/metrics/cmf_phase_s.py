"""Seconds a flightline of the fused stage's CMF phase: the mean over the
window of ``run_flightline(...)["timers"]["cmf phase"]`` (K1, eigh and K2
on the slabs the masks' read filled, and the product's write); the fused
stage has no ``timers["cmf"]``."""


def read(run):
    t = [u["cmf phase"] for u in run.layer.get("timers", []) if "cmf phase" in u]
    return sum(t) / len(t) if t else None
