"""The program's own spans of the window's CMF products, as the multimodal
cell's span metrics read them: ``srcfinder_torch.trace.spans()``, grouped
by trace, of the last ``run.units`` ``cmf.image`` roots (the warm-up
product of set-up comes before them). A program without these spans gives
none."""

from __future__ import annotations


def _products():
    try:
        from srcfinder_torch.trace import spans
    except ModuleNotFoundError:
        return [], []
    log = spans()
    return log, [s for s in log if s.name == "cmf.image" and s.parent_id is None]


def _trees(log, roots):
    trees = {r.trace_id: [] for r in roots}
    for s in log:
        if s.trace_id in trees:
            trees[s.trace_id].append(s)
    return [trees[r.trace_id] for r in roots]


def window_products(run):
    """[spans of its trace] of each of the window's products, oldest
    first; [] when there are none to read."""
    log, roots = _products()
    return _trees(log, roots[-run.units:] if run.units else [])


def last_product():
    """The spans of the last product made, or []."""
    log, roots = _products()
    return _trees(log, roots[-1:])[0] if roots else []


def seconds_per_product(run, names):
    """The mean over the window's products of the summed seconds of their
    spans named in ``names``, or None when no product has one."""
    trees = window_products(run)
    if not any(s.name in names for tree in trees for s in tree):
        return None
    return sum(s.seconds for tree in trees for s in tree if s.name in names) / len(trees)


def rejected_per_mode(tree):
    """The ``rejected`` counts of a product's ``cmf.mode`` spans that lie
    directly under a column chunk, summed by mode, or None without them."""
    chunks = {s.span_id for s in tree if s.name == "cmf.chunk"}
    out = {}
    for s in tree:
        if s.name == "cmf.mode" and s.parent_id in chunks:
            out.setdefault(s.parent_id, []).append(s.counts.get("rejected", 0))
    if not out:
        return None
    return [sum(col) for col in zip(*out.values())]
