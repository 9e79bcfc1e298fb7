"""The reduction of the program's spans in a traced slice
(`perfbench.stages`): device time by the stage that launched it, idle time
inside host copies as an exact intersection, idle gaps labelled by spans of
either prefix, and nothing read from a trace without the program's spans."""

import pytest

from conftest import ROOT
from perfbench import stages, trace
from test_trace import ev

CALL = "perfbench.call"


def launch(name, ts, dur, corr, cat="cuda_runtime"):
    return {**ev(cat, name, ts, dur), "args": {"correlation": corr}}


def op(cat, name, ts, dur, corr):
    return {**ev(cat, name, ts, dur, tid=7), "args": {"correlation": corr}}


def one_call():
    """One bootstrap call over [0, 100): a host copy in the preparation
    (the host waits [6, 14) in the synchronize), then a launch in each
    later stage, the rotation's inside its kernel wrapper."""
    return [
        ev("user_annotation", CALL, 0, 100),
        ev("user_annotation", "peba1.prepare", 2, 18),
        ev("user_annotation", "peba1.sync_copy", 5, 10),
        launch("cudaMemcpyAsync", 5, 1, 1),
        ev("cuda_runtime", "cudaStreamSynchronize", 6, 8),
        ev("user_annotation", "peba1.modswitch", 20, 4),
        launch("cudaLaunchKernel", 21, 1, 2),
        ev("user_annotation", "peba1.rotation", 24, 36),
        ev("user_annotation", "peba1.kernel.blind_rotate_gen_full", 26, 30),
        launch("cudaLaunchCooperativeKernel", 30, 2, 3),
        ev("user_annotation", "peba1.extract", 60, 10),
        launch("cudaLaunchKernel", 62, 1, 4, cat="cuda_driver"),
        ev("user_annotation", "peba1.keyswitch", 70, 25),
        launch("cudaLaunchKernel", 72, 1, 5),
        op("gpu_memcpy", "Memcpy HtoD", 13, 1, 1),
        op("kernel", "modswitch", 22, 3, 2),
        op("kernel", "rotation", 31, 59, 3),
        op("kernel", "extract", 90, 2, 4),
        op("kernel", "keyswitch", 92, 7, 5),
    ]


def test_device_time_goes_to_the_stage_that_launched_it():
    s = stages.reduce_spans(one_call())
    got = {name: pytest.approx(span.device_s * 1e6) for name, span in s.by_name.items()}
    assert got == {"peba1.prepare": 1, "peba1.sync_copy": 1, "peba1.modswitch": 3,
                   "peba1.rotation": 59, "peba1.kernel.blind_rotate_gen_full": 59,
                   "peba1.extract": 2, "peba1.keyswitch": 7}
    assert s.calls == 1 and s.unlaunched == []
    assert s.device_s == pytest.approx(72e-6)
    assert s.stage_s == pytest.approx(s.device_s) and s.call_s == pytest.approx(s.device_s)


def test_counts_host_time_and_the_idle_time_inside_a_span():
    s = stages.reduce_spans(one_call()).by_name
    assert {name: span.count for name, span in s.items()} == dict.fromkeys(s, 1)
    assert s["peba1.kernel.blind_rotate_gen_full"].host_s == pytest.approx(30e-6)
    # Busy [13, 14), [22, 25), [31, 99): the copy's span [5, 15) meets the
    # idle [0, 13) and [14, 22) in [5, 13) and [14, 15).
    assert s["peba1.sync_copy"].idle_s == pytest.approx(9e-6)
    assert s["peba1.prepare"].idle_s == pytest.approx(17e-6)
    assert s["peba1.rotation"].idle_s == pytest.approx(6e-6)        # [25, 31)


def test_overlap_is_the_exact_intersection():
    a = [(0, 10), (20, 30), (40, 50)]
    b = [(5, 25), (28, 29), (45, 60)]
    assert stages.overlap(a, b) == 5 + 5 + 1 + 5
    assert stages.overlap(a, []) == 0 and stages.overlap([], b) == 0


def test_an_operation_with_no_launch_is_unattributed():
    events = one_call() + [op("kernel", "lost", 40, 5, 99)]
    s = stages.reduce_spans(events)
    assert s.unlaunched == [["lost", pytest.approx(5e-6)]]
    assert s.by_name["peba1.rotation"].device_s == pytest.approx(59e-6)
    assert s.stage_s == pytest.approx(s.device_s - 5e-6)


def test_operations_outside_every_stage_lower_the_share():
    events = one_call() + [ev("user_annotation", CALL, 100, 20),
                           launch("cudaLaunchKernel", 101, 1, 6),
                           op("kernel", "between", 110, 8, 6),
                           launch("cudaLaunchKernel", 125, 1, 7)]
    s = stages.reduce_spans(events)
    assert s.call_s == pytest.approx(80e-6)
    assert s.stage_s == pytest.approx(72e-6)
    assert stages.as_json(events)["stage_share"] == pytest.approx(72 / 80)


def test_idle_gaps_are_labelled_by_the_innermost_span_of_either_prefix():
    gaps = dict((k, v) for k, v in stages.idle_gaps(one_call()))
    # [0, 13): mid 6.5, in the copy's span, the host in the synchronize.
    assert gaps["peba1.sync_copy/cudaStreamSynchronize"] == pytest.approx(13e-6)
    # [14, 22): mid 18, in the preparation, in Python.
    assert gaps["peba1.prepare/python"] == pytest.approx(8e-6)
    # [25, 31): mid 28, inside the wrapper.
    assert gaps["peba1.kernel.blind_rotate_gen_full/python"] == pytest.approx(6e-6)
    assert gaps["perfbench.call/python"] == pytest.approx(1e-6)        # [99, 100)


def test_a_trace_without_program_spans_reads_as_before():
    events = [e for e in one_call() if not e["name"].startswith("peba1.")]
    assert stages.idle_gaps(events)[:trace.TOP] == trace.reduce_events(events).idle_gaps
    s = stages.reduce_spans(events)
    assert s.by_name == {} and s.stage_s == 0
    assert stages.readings(s) == dict.fromkeys(stages.readings(None))
    assert all(v is None for v in stages.readings(None).values())


def test_nothing_traced_reads_nothing():
    assert stages.reduce_spans([ev("cpu_op", "aten::add", 0, 10)]) is None
    assert stages.idle_gaps([]) == []
    assert set(stages.as_json([])) == {"readings", "idle_gaps"}


def test_readings_per_call():
    r = stages.readings(stages.reduce_spans(one_call()))
    assert r == {"rotation_ms": pytest.approx(59e-3), "keyswitch_ms": pytest.approx(7e-3),
                 "sync_idle_ms": pytest.approx(9e-3), "sync_copies_per_call": 1.0,
                 "wrapper_us": pytest.approx(30.0)}
    # Program spans without a host copy: the copies read 0, not nothing.
    events = [e for e in one_call() if e["name"] != "peba1.sync_copy"]
    r = stages.readings(stages.reduce_spans(events))
    assert r["sync_copies_per_call"] == 0 and r["sync_idle_ms"] == 0


def test_the_tool_loads_no_jax_nor_the_jax_package():
    from perfbench.run import FORBIDDEN
    from test_imports import loaded
    assert not loaded("perfbench.stages") & set(FORBIDDEN)


def test_a_traced_run_holds_the_programs_spans_on_the_call_thread(toy):
    """The auth cell at toy size on the CPU: every call's five stages lie
    inside the harness's call spans (no device, so nothing is reduced)."""
    import torch

    from perfbench import run as run_mod
    from test_harness import AUTH, SEED
    run = run_mod.Run(toy, AUTH, SEED, 1.5, True, torch.device("cpu"))
    result, _, events = stages.traced_run(run)
    assert result["correct"]
    tid = next(e["tid"] for e in events if e.get("name") == CALL)
    mine = [e for e in events if e.get("cat") == "user_annotation" and e["tid"] == tid]
    calls = [e for e in mine if e["name"] == CALL]
    first, last = calls[0]["ts"], calls[-1]["ts"] + calls[-1]["dur"]
    names = [e["name"] for e in mine if e["name"].startswith("peba1.")
             and first <= e["ts"] <= last]
    for stage in stages.STAGES:
        assert names.count(stage) == len(calls), stage
    assert names.count("peba1.kernel.blind_rotate_gen_full") == len(calls)
    assert stages.as_json(events) == {"readings": stages.readings(None), "idle_gaps": []}


def test_without_a_card_the_tool_exits_non_zero(capsys, monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(ROOT)
    assert stages.main(["--workload", "auth1_tfhe128", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""
