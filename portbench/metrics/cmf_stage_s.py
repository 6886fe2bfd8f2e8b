"""Seconds of the CMF stage per flightline: the mean over the window of the
program's own stage clock, ``run_flightline(...)["timers"]["cmf"]``."""


def read(run):
    t = [u["cmf"] for u in run.layer.get("timers", []) if "cmf" in u]
    return sum(t) / len(t) if t else None
