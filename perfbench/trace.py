"""The traced slice of a run: `torch.profiler` over a few bootstrap calls of
the window, and its reduction to device busy time, idle gaps and kernel
time by name.

The profiler (CPU and CUDA activities) is started before call `first` of the
window, once the device has finished the calls before it (a call still
running when the profiler starts may go unrecorded and read as idle time),
and stopped after call `first + count - 1` has finished on the device.  Its Chrome trace is written to a temporary directory, read and
deleted after the window has closed.  The harness's own spans
(`torch.profiler.record_function`) name the calls into each layer:
`perfbench.request` around a request, `perfbench.call` around a bootstrap
call (a gate, a MUX or a circuit level).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime")
SPAN_PREFIX = "perfbench."
CALL_SPAN = "perfbench.call"
REQUEST_SPAN = "perfbench.request"
TOP = 10


@dataclasses.dataclass
class Interval:
    name: str
    start: float      # microseconds, the trace's clock
    end: float


@dataclasses.dataclass
class Slice:
    """What the traced slice holds, reduced."""

    window_s: float
    busy_s: float
    kernels: int                      # device kernel launches in the window
    calls: int                        # bootstrap calls traced
    device_ops: "list[list]"          # [[name, seconds], ...], the most time first
    idle_gaps: "list[list]"           # [[host activity, seconds], ...]


class Tracer:
    """Profiles bootstrap calls [first, first + count) of a window; a no-op
    when disabled."""

    def __init__(self, enabled: bool, first: int = 0, count: int = 0):
        self.enabled = enabled
        self.first, self.count = first, count
        self.prof = None
        self.done = False

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Start and stop a profiler once, in set-up: the first start in a
        process initialises the device tracing library."""
        if self.enabled:
            prof = self._profiler()
            prof.start()
            prof.stop()

    def before_call(self, index: int) -> None:
        if self.enabled and index == self.first and self.prof is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof = self._profiler()
            self.prof.start()

    def after_call(self, index: int) -> None:
        if self.prof is not None and not self.done and index == self.first + self.count - 1:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def close(self) -> None:
        """Stop a profiler that the window left running (a window shorter
        than the slice)."""
        if self.prof is not None and not self.done:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def reduce(self) -> "Slice | None":
        """The slice's numbers, or None where nothing was traced."""
        if self.prof is None:
            return None
        self.close()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.prof = None
        return reduce_events(events)


def _intervals(events, categories, tid=None) -> "list[Interval]":
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in categories and (
                tid is None or e.get("tid") == tid):
            start = float(e["ts"])
            out.append(Interval(e.get("name", "?"), start, start + float(e.get("dur", 0.0))))
    return out


def union(intervals: "list[Interval]", lo: float, hi: float) -> "list[tuple[float, float]]":
    """The union of the intervals, clipped to [lo, hi], as sorted disjoint pairs."""
    merged: list = []
    for iv in sorted(intervals, key=lambda iv: iv.start):
        s, e = max(iv.start, lo), min(iv.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def innermost(intervals: "list[Interval]", points: "list[float]") -> "list[str | None]":
    """For each point, the name of the latest-starting interval that contains
    it (the innermost, for intervals nested as one thread's calls are)."""
    ivs = sorted(intervals, key=lambda iv: (iv.start, -iv.end))
    starts = [iv.start for iv in ivs]
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: "list[str | None]" = [None] * len(points)
    stack: "list[Interval]" = []
    nxt = 0
    for i in order:
        t = points[i]
        hi = bisect.bisect_right(starts, t)
        while nxt < hi:
            iv = ivs[nxt]
            while stack and stack[-1].end < iv.start:
                stack.pop()
            stack.append(iv)
            nxt += 1
        while stack and stack[-1].end < t:
            stack.pop()
        if stack:
            out[i] = stack[-1].name
    return out


def _top(totals: dict) -> "list[list]":
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce_events(events: list) -> "Slice | None":
    """Busy and idle time of the device over the traced window, kernel time
    by name, and the idle gaps by what the host was doing.  The window runs
    from the first traced bootstrap call's start to the later of its last
    device operation's and last call's end."""
    device = _intervals(events, DEVICE_CATEGORIES)
    tid = next((e.get("tid") for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == CALL_SPAN), None)
    spans = [iv for iv in _intervals(events, ("user_annotation",), tid)
             if iv.name.startswith(SPAN_PREFIX)]
    calls = [iv for iv in spans if iv.name == CALL_SPAN]
    if not calls or not device:
        return None
    lo = min(iv.start for iv in calls)
    hi = max(max(iv.end for iv in device), max(iv.end for iv in calls))
    busy = union(device, lo, hi)
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for iv in device:
        if lo < iv.end and iv.start < hi:
            by_name[iv.name] = by_name.get(iv.name, 0.0) + (iv.end - iv.start) * 1e-6
    kernels = sum(1 for iv in _intervals(events, ("kernel",)) if lo <= iv.start < hi)
    gaps, edge = [], lo
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if hi > edge:
        gaps.append((edge, hi))
    mids = [(s + e) / 2 for s, e in gaps]
    host = _intervals(events, HOST_CATEGORIES, tid)
    span_at, op_at = innermost(spans, mids), innermost(host, mids)
    by_host: dict = {}
    for (s, e), span, op in zip(gaps, span_at, op_at):
        label = f"{span or 'outside'}/{op or 'python'}"
        by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6
    return Slice(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, kernels=kernels,
                 calls=len(calls), device_ops=_top(by_name), idle_gaps=_top(by_host))
