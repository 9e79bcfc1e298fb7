"""The cell `identify4_tfhe128` at toy sizes on the CPU: a traced sound run
reads the tournament's counter, and the control and each fault under the
timed path are not correct."""

import json

import pytest
import torch

from conftest import ROOT
from perfbench import port
from perfbench import run as run_mod
from perfbench.kinds import identify_closed
from test_harness import altered, half_batch, unchanged

CELL = "identify4_tfhe128"
SEED = 2**33 + 29


@pytest.fixture
def toy_identify(toy, monkeypatch):
    # Every row of every call: a fault in one row of a call shows.
    monkeypatch.setattr(identify_closed, "CHECK_CALLS", 1000)
    monkeypatch.setattr(identify_closed, "CHECK_ROWS", 10**6)
    monkeypatch.setattr(identify_closed, "TRACE_CALLS", (5, 10))
    return toy


def execute(root, trace=False, control=False):
    run = run_mod.Run(root, CELL, SEED, 1.5, trace, torch.device("cpu"), control=control)
    result, checks = run.execute()
    return result, {c.name: c.value for c in checks}


def test_the_cell_is_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    gallery = json.loads((ROOT / config["file"]).read_text())["gallery"]
    assert traffic["templates"] == gallery["templates"] == 4


def test_a_traced_sound_run_reads_the_tournament(toy_identify):
    result, checks = execute(toy_identify, trace=True)
    assert result["correct"], checks
    metrics = result["metrics"]
    config = json.loads((toy_identify / "perfbench/configs/peba1_identify_tfhe128.json")
                        .read_text())
    calls = identify_closed.replay_calls(port.protocol(config), 4, config["tfhe"]["n"])
    assert metrics["auth.bootstrap_calls"]["value"] == len(calls)
    assert metrics["identify.argmin_bootstraps"]["value"] > 0
    assert metrics["auth.call_ms"]["value"] > 0


def test_the_control_is_not_correct(toy_identify):
    result, checks = execute(toy_identify, control=True)
    assert not result["correct"]
    assert checks["call_row_mismatches"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_a_fault_under_the_timed_path_is_not_correct(toy_identify, monkeypatch, fault):
    from peba1_tpu_torch.ops import bootstrap as bs
    monkeypatch.setattr(bs, "bootstrap", fault(bs.bootstrap))
    result, checks = execute(toy_identify)
    assert not result["correct"], checks
    assert result["failed"] >= 1


def test_the_traced_slice_is_60_calls_of_512_to_2048_rows():
    """At the cell's own sizes, by the kind's replay of a request."""
    config = json.loads((ROOT / "perfbench/configs/peba1_identify_tfhe128.json").read_text())
    calls = identify_closed.replay_calls(port.protocol(config), 4, config["tfhe"]["n"])
    assert len(calls) == 1154 and sum(b for _, _, b in calls) == 852720
    first, count = identify_closed.TRACE_CALLS
    assert count == 60
    assert all(512 <= b <= 2048 for _, _, b in calls[first:first + count])
