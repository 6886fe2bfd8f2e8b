"""Seconds of the FCN stage per flightline: the mean over the window of
``run_flightline(...)["timers"]["fcn"]``."""


def read(run):
    t = [u["fcn"] for u in run.layer.get("timers", []) if "fcn" in u]
    return sum(t) / len(t) if t else None
