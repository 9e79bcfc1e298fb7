"""The program's own spans in a traced slice, reduced by stage.

``peba1_tpu_torch`` opens ``peba1.*`` ranges (its ``utils/logging.span``)
at the stages of a bootstrap call: ``prepare``, ``modswitch``, ``rotation``,
``extract`` and ``keyswitch`` side by side, and inside them ``sync_copy`` (a
copy of host values to the card, which waits for the stream) and
``kernel.<wrapper>`` (a call of a kernel wrapper).  Over the window that
`trace.reduce_events` takes, `reduce_spans` gives for each span name its
count, its host seconds, the device seconds of the operations launched
inside it, and the device's idle seconds inside it; `idle_gaps` labels the
idle gaps as `trace.reduce_events` does, but by the innermost span of either
prefix (``perfbench.`` or ``peba1.``).

A device operation is tied through its `correlation` to the CUDA runtime or
driver call that launched it, and that call to the innermost program span
open at its start on the call thread; the operation's time counts for that
span and for every span around it.

`trace.reduce_events` reads none of this: `readings` gives the numbers a
per-layer reader would take from it, for each traced call.

    python3 -m perfbench.stages --workload <cell> --seed <n> --seconds <s>

makes one traced run of a cell, as ``python3 -m perfbench.run --workload
<cell> ... --trace 1`` does, and prints its result line with `spans` added.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from unittest import mock

from . import run as run_mod
from . import trace

PROGRAM_PREFIX = "peba1."
STAGES = tuple(PROGRAM_PREFIX + s for s in ("prepare", "modswitch", "rotation", "extract",
                                             "keyswitch"))
SYNC_COPY = PROGRAM_PREFIX + "sync_copy"
KERNEL_PREFIX = PROGRAM_PREFIX + "kernel."
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Span:
    """One span name's totals over the window."""

    count: int = 0          # spans opened in the window
    host_s: float = 0.0     # the union of their time
    device_s: float = 0.0   # device operations launched inside them
    idle_s: float = 0.0     # the device's idle time inside them


@dataclasses.dataclass
class Spans:
    calls: int
    device_s: float                  # every device operation of the window
    call_s: float                    # of it, launched inside a bootstrap call
    stage_s: float                   # of it, launched inside one of `STAGES`
    unlaunched: "list[list]"         # [[name, seconds], ...] with no launch found
    by_name: "dict[str, Span]"


def _window(events):
    """(call thread, lo, hi, call spans, device intervals) as `trace.reduce_events`
    takes them, or None."""
    device = trace._intervals(events, trace.DEVICE_CATEGORIES)
    tid = next((e.get("tid") for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == trace.CALL_SPAN), None)
    calls = [iv for iv in trace._intervals(events, ("user_annotation",), tid)
             if iv.name == trace.CALL_SPAN]
    if not calls or not device:
        return None
    lo = min(iv.start for iv in calls)
    hi = max(max(iv.end for iv in device), max(iv.end for iv in calls))
    return tid, lo, hi, calls, device


def _gaps(busy, lo: float, hi: float) -> "list[tuple[float, float]]":
    gaps, edge = [], lo
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if hi > edge:
        gaps.append((edge, hi))
    return gaps


def overlap(a, b) -> float:
    """The measure of the intersection of two sorted lists of disjoint
    (start, end) pairs."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def enclosing(intervals: "list[trace.Interval]", points: "list[float]") -> "list[tuple]":
    """For each point, the names of the intervals that contain it, outermost
    first (intervals nested as one thread's calls are)."""
    ivs = sorted(intervals, key=lambda iv: (iv.start, -iv.end))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: "list[tuple]" = [()] * len(points)
    stack: "list[trace.Interval]" = []
    nxt = 0
    for i in order:
        t = points[i]
        while nxt < len(ivs) and ivs[nxt].start <= t:
            iv = ivs[nxt]
            while stack and stack[-1].end < iv.start:
                stack.pop()
            stack.append(iv)
            nxt += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[i] = tuple(iv.name for iv in stack if iv.start <= t <= iv.end)
    return out


def reduce_spans(events: list) -> "Spans | None":
    """The program's spans over the traced window, or None where nothing was
    traced (no bootstrap call or no device operation)."""
    window = _window(events)
    if window is None:
        return None
    tid, lo, hi, calls, device = window
    spans = [iv for iv in trace._intervals(events, ("user_annotation",), tid)
             if iv.name.startswith(PROGRAM_PREFIX) and iv.start < hi and lo < iv.end]
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATEGORIES
           and lo < float(e["ts"]) + float(e.get("dur", 0.0)) and float(e["ts"]) < hi]
    starts = [launched.get((e.get("args") or {}).get("correlation")) for e in ops]
    points = [t if t is not None else -1.0 for t in starts]
    inside, in_call = enclosing(spans, points), enclosing(calls, points)
    by_name = {name: Span() for name in sorted({iv.name for iv in spans})}
    unlaunched: dict = {}
    device_s = call_s = stage_s = 0.0
    for e, t, names, call in zip(ops, starts, inside, in_call):
        dur = float(e.get("dur", 0.0)) * 1e-6
        device_s += dur
        if t is None:
            unlaunched[e.get("name", "?")] = unlaunched.get(e.get("name", "?"), 0.0) + dur
        for name in set(names):
            by_name[name].device_s += dur
        call_s += dur if call else 0.0
        if any(n in STAGES for n in names):
            stage_s += dur
    idle = _gaps(trace.union(device, lo, hi), lo, hi)
    for name, s in by_name.items():
        mine = [iv for iv in spans if iv.name == name]
        s.count = sum(1 for iv in mine if lo <= iv.start < hi)
        own = trace.union(mine, lo, hi)
        s.host_s = sum(e - b for b, e in own) * 1e-6
        s.idle_s = overlap(own, idle) * 1e-6
    return Spans(calls=len(calls), device_s=device_s, call_s=call_s, stage_s=stage_s,
                 unlaunched=trace._top(unlaunched), by_name=by_name)


def idle_gaps(events: list) -> "list[list]":
    """The idle gaps of the window by what the host was doing at their
    middle, labelled as `trace.reduce_events` labels them but by the
    innermost span of either prefix; every label, the most time first."""
    window = _window(events)
    if window is None:
        return []
    tid, lo, hi, _, device = window
    gaps = _gaps(trace.union(device, lo, hi), lo, hi)
    spans = [iv for iv in trace._intervals(events, ("user_annotation",), tid)
             if iv.name.startswith((trace.SPAN_PREFIX, PROGRAM_PREFIX))]
    mids = [(s + e) / 2 for s, e in gaps]
    host = trace._intervals(events, trace.HOST_CATEGORIES, tid)
    by_host: dict = {}
    for (s, e), span, op in zip(gaps, trace.innermost(spans, mids), trace.innermost(host, mids)):
        label = f"{span or 'outside'}/{op or 'python'}"
        by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])]


def readings(spans: "Spans | None") -> dict:
    """Per traced call: the rotation's and the keyswitch's device ms, the
    device's idle ms inside host copies, the host copies, and the kernel
    wrappers' host µs.  None where the slice holds no program span (a
    program without them); a span name absent beside others reads 0."""
    names = ("rotation_ms", "keyswitch_ms", "sync_idle_ms", "sync_copies_per_call",
             "wrapper_us")
    if spans is None or not spans.by_name or not spans.calls:
        return dict.fromkeys(names)
    get, c = spans.by_name.get, spans.calls
    none = Span()
    return {"rotation_ms": 1e3 * get(STAGES[2], none).device_s / c,
            "keyswitch_ms": 1e3 * get(STAGES[4], none).device_s / c,
            "sync_idle_ms": 1e3 * get(SYNC_COPY, none).idle_s / c,
            "sync_copies_per_call": get(SYNC_COPY, none).count / c,
            "wrapper_us": 1e6 * sum(s.host_s for n, s in spans.by_name.items()
                                    if n.startswith(KERNEL_PREFIX)) / c}


def as_json(events: list) -> dict:
    """What `main` adds to the result line."""
    spans = reduce_spans(events)
    out = {"readings": readings(spans), "idle_gaps": idle_gaps(events)}
    if spans is not None:
        out.update(calls=spans.calls, device_s=spans.device_s, call_s=spans.call_s,
                   stage_s=spans.stage_s,
                   stage_share=spans.stage_s / spans.device_s if spans.device_s else None,
                   unlaunched=spans.unlaunched,
                   by_name={n: dataclasses.asdict(s) for n, s in spans.by_name.items()})
    return out


def traced_run(run) -> "tuple[dict, list, list]":
    """`run.execute()` of a traced run, keeping the slice's trace events:
    (result, checks, events)."""
    kept: list = []
    reduce_events = trace.reduce_events

    def keep(events):
        kept.append(events)
        return reduce_events(events)

    with mock.patch.object(trace, "reduce_events", keep):
        result, judged = run.execute()
    return result, judged, kept[0] if kept else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import spec as spec_mod
    from .checks import lines
    chips = int(spec_mod.Spec.load(os.getcwd()).cell(args.workload)["chips"])
    device = run_mod.card(chips)
    if device is None:
        print(f"perfbench: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 3
    run_mod.log(run_mod.card_label())
    run = run_mod.Run(os.getcwd(), args.workload, args.seed, args.seconds, True, device)
    result, judged, events = traced_run(run)
    found = run_mod.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["spans"] = as_json(events)
    result["checks"] = checks
    for line in lines(judged):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
