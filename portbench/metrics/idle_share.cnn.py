"""Share of the window in which no kernel, copy or set ran on the card
(on four cards, the mean of their shares)."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
