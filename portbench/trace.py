"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer metrics and the result's ``breakdown`` read.

The window is the span of a ``portbench.window`` annotation around the
measured loop. Device time is the union of the intervals in which a
kernel, copy or set ran on a card (the profiler's own buffer markers left
out), clipped to the window; idle gaps are what the window leaves
uncovered on the first card, each named by the innermost host event open
at its middle. The profiler's raw events are read directly, without the
event tree it builds on request.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from contextlib import ExitStack

PROFILER_MARKERS = ("Buffer Flush", "Activity Buffer Request")
WINDOW = "portbench.window"
TOP = 10


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class TraceSummary:
    """Device work of one traced window, in seconds."""

    def __init__(self, window, devices, kernels, host):
        t0, t1 = window
        self.window_s = (t1 - t0) / 1e9
        self.devices = list(devices)
        self._host = host                # [(start, end, name)] of host events
        spans = defaultdict(list)
        self.kernel_s = defaultdict(float)
        self.kernel_s_by_device = defaultdict(lambda: defaultdict(float))
        for dev, name, a, b in kernels:
            spans[dev].append((a, b))
            self.kernel_s[name] += (b - a) / 1e9
            self.kernel_s_by_device[dev][name] += (b - a) / 1e9
        self.busy_s = {}
        merged0 = []
        for d in self.devices:
            merged = _merge(spans.get(d, []))
            self.busy_s[d] = sum(b - a for a, b in merged) / 1e9
            if d == self.devices[0]:
                merged0 = merged
        self.idle_gaps = self._gaps(t0, t1, merged0)

    def _gaps(self, t0, t1, merged):
        opened = sorted(self._host)
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        names = _hosts_at(opened, [(a + b) / 2 for a, b in gaps])
        total = defaultdict(float)
        for (a, b), name in zip(gaps, names):
            total[name] += (b - a) / 1e9
        return sorted(([k[:200], v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]

    def busy_mean_s(self):
        return sum(self.busy_s.values()) / len(self.devices)

    def idle_share(self, device=None):
        """1 - covered / window, for one device or the mean over devices."""
        devs = self.devices if device is None else [device]
        return sum(1.0 - self.busy_s[d] / self.window_s for d in devs) / len(devs)

    def matching_s(self, pattern, device=None):
        """Device seconds of the kernels whose name matches ``pattern``."""
        table = self.kernel_s if device is None else self.kernel_s_by_device.get(device, {})
        rx = re.compile(pattern)
        return sum(s for name, s in table.items() if rx.search(name))

    def top_ops(self):
        rows = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:200], s] for name, s in rows]


class Tracer:
    """``with Tracer(devices) as t: ...`` profiles the block;
    ``t.summary()`` reduces it."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.stack = ExitStack()
        self.prof = self.stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self.stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)

    def summary(self) -> TraceSummary:
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        window = next((e.start_ns(), e.end_ns()) for e in events if e.name() == WINDOW)
        t0, t1 = window
        kernels, host = [], []
        for e in events:
            name = e.name()
            if name == WINDOW:
                continue
            if e.device_type() == DeviceType.CUDA:
                # the device-side copies of host annotations are not device work
                if name in PROFILER_MARKERS or e.is_user_annotation():
                    continue
                a, b = max(e.start_ns(), t0), min(e.end_ns(), t1)
                if b > a:
                    kernels.append((e.device_index(), name, a, b))
            else:
                host.append((e.start_ns(), e.end_ns(), name))
        return TraceSummary(window, self.devices, kernels, host)


def _hosts_at(opened, times):
    """For each of the ascending ``times``, the name of the innermost host
    event open then: the latest-starting of ``opened`` (sorted by start)
    that has not ended."""
    heap, out, i = [], [], 0
    for t in times:
        while i < len(opened) and opened[i][0] <= t:
            a, b, name = opened[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host outside any profiled op")
    return out
