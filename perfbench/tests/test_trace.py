"""The reduction of a traced slice: busy time as the union of device
intervals over the window, idle gaps labelled by the host's innermost span
and operation."""

import pytest

from perfbench import trace


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0}


def test_busy_idle_and_breakdown():
    events = [
        ev("user_annotation", "perfbench.call", 0, 100),
        ev("user_annotation", "perfbench.call", 100, 100),
        ev("cpu_op", "aten::copy_", 10, 20),
        ev("cuda_runtime", "cudaStreamSynchronize", 12, 15),
        ev("cpu_op", "aten::add", 150, 30),
        ev("kernel", "rotation", 30, 60, tid=7),
        ev("kernel", "rotation", 80, 40, tid=7),        # overlaps the first
        ev("gpu_memcpy", "copy", 160, 10, tid=8),
        ev("kernel", "keyswitch", 190, 30, tid=7),       # ends after the last call
    ]
    s = trace.reduce_events(events)
    assert s.window_s == pytest.approx(220e-6)
    # Busy: [30, 120) and [160, 170) and [190, 220): 130 us of 220.
    assert s.busy_s == pytest.approx(130e-6)
    assert s.kernels == 3 and s.calls == 2
    assert s.device_ops[0] == ["rotation", pytest.approx(100e-6)]
    gaps = dict((k, v) for k, v in s.idle_gaps)
    # [0, 30): the host in the synchronize inside the copy; [120, 160) and
    # [170, 190): inside the second call's add or in Python.
    assert gaps["perfbench.call/cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps["perfbench.call/aten::add"] == pytest.approx(20e-6)
    assert gaps["perfbench.call/python"] == pytest.approx(40e-6)


def test_nothing_traced_reads_nothing():
    assert trace.reduce_events([ev("cpu_op", "aten::add", 0, 10)]) is None
    assert trace.Tracer(False).reduce() is None
