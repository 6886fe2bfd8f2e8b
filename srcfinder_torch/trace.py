"""The port's span recorder.

``with span(name, **counts) as s:`` records one span of the program: its
name, its trace (the id of the outermost span open around it, shared by
every span opened inside that one), its parent, its start and end on
``time.time_ns()`` and counts given at entry or added with ``s.count(...)``.
``time.time_ns()`` is the clock ``torch.profiler`` stamps its events with,
so a span lines up with the device lanes of a trace. Parents pass through a
context variable, so no signature carries them. Finished spans go into a
bounded log (:data:`LOG_SIZE`), which :func:`spans` reads.

While ``torch.profiler`` records, a span also enters
``record_function(name)``, so the trace names the program's own spans.
Otherwise it enters nothing (``record_function`` costs ~14 us even with no
profiler on): two clock reads and an append.

:class:`DeviceSpan` is a span that synchronises its card on a clean exit,
so that its clock covers the kernels queued inside it. :class:`Stage` is
such a span for a stage of a pipeline: it also announces itself on a
progress callback and records its seconds into a ``timers`` dict.
"""

from __future__ import annotations

import contextvars
import itertools
import time
from collections import deque

import torch

__all__ = ["LOG_SIZE", "DeviceSpan", "Span", "Stage", "span", "spans"]

#: Finished spans kept in the log, the oldest dropped first (a flightline
#: through ``run_flightline`` records about 30).
LOG_SIZE = 4096

_log: deque = deque(maxlen=LOG_SIZE)
_ids = itertools.count(1)
_open: contextvars.ContextVar = contextvars.ContextVar("srcfinder_torch.trace.open",
                                                       default=None)


class Span:
    """One span; a context manager, and the record the log keeps."""

    __slots__ = ("name", "counts", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "_token", "_rf")

    def __init__(self, name: str, **counts):
        self.name = name
        self.counts = counts
        self.trace_id = self.span_id = self.parent_id = None
        self.start_ns = self.end_ns = None

    def count(self, **counts):
        """Adds ``counts`` to the span's own (a new key starts at 0)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        return self

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        parent = _open.get()
        self.span_id = next(_ids)
        if parent is None:
            self.trace_id = self.span_id
        else:
            self.trace_id, self.parent_id = parent.trace_id, parent.span_id
        self._token = _open.set(self)
        self._rf = None
        # stamped outside the profiler's event, which then lies within the
        # span (a process's first record_function takes ~1 ms to enter)
        self.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._exit_profiler(*exc)
        self.end_ns = time.time_ns()
        self._close()
        return False

    def _exit_profiler(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None

    def _close(self):
        _open.reset(self._token)
        _log.append(self)

    def __repr__(self):
        took = "open" if self.end_ns is None else f"{self.seconds:.6f}s"
        return (f"Span({self.name!r}, {took}, id={self.span_id}, parent={self.parent_id}, "
                f"trace={self.trace_id}, counts={self.counts})")


class DeviceSpan(Span):
    """A span whose ``device`` (a CUDA device; anything else is not
    waited on) is synchronised on a clean exit, before the span's end is
    stamped."""

    __slots__ = ("device",)

    def __init__(self, name: str, device=None, **counts):
        super().__init__(name, **counts)
        self.device = device

    def _sync(self, exc_type):
        if exc_type is None and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        self._sync(exc[0])
        return super().__exit__(*exc)


class Stage(DeviceSpan):
    """A stage: "[STAGE] name" on ``progress`` once open, its card
    synchronised on a clean exit, ``timers[name]`` set to its seconds and
    "[STAGE] name done in S s" on ``progress`` before it closes."""

    __slots__ = ("timers", "progress")

    def __init__(self, name: str, timers: dict, progress, device=None):
        super().__init__(name, device)
        self.timers, self.progress = timers, progress

    def __enter__(self):
        super().__enter__()
        self.progress(f"[STAGE] {self.name}")
        return self

    def __exit__(self, *exc):
        self._sync(exc[0])
        self.end_ns = time.time_ns()
        self.timers[self.name] = self.seconds
        try:
            # inside the profiler's event, so that a span the callback
            # closes nests in it
            self.progress(f"[STAGE] {self.name} done in {self.seconds:.1f}s")
        finally:
            self._exit_profiler(*exc)
            self._close()
        return False


#: ``with span(name, bytes=...) as s:`` records a span (see the module).
span = Span


def spans(trace_id: int | None = None) -> list:
    """The finished spans in the log, in the order they closed (children
    before their parents); only those of trace ``trace_id`` when given."""
    log = list(_log)
    return log if trace_id is None else [s for s in log if s.trace_id == trace_id]

