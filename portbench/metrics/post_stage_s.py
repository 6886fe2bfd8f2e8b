"""Seconds of the host post-processing per flightline (plume candidates and
IME): the mean over the window of ``timers["salience"] + timers["ime"]``."""


def read(run):
    t = [u["salience"] + u.get("ime", 0.0) for u in run.layer.get("timers", [])
         if "salience" in u]
    return sum(t) / len(t) if t else None
