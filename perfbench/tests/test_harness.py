"""Whole runs at toy sizes on the CPU, past the harness's look for a card:
sound runs are correct; the control and each fault a cell can have under
the timed path are not."""

import json

import pytest
import torch

from conftest import ROOT
from perfbench import run as run_mod

CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())
GATE = next(w["name"] for w in CELLS["workloads"] if w["traffic"].startswith("gate_chain"))
AUTH = next(w["name"] for w in CELLS["workloads"] if w["traffic"].startswith("auth_closed"))
SEED = 2**33 + 17


def execute(root, cell, trace=False, control=False, seconds=1.5):
    run = run_mod.Run(root, cell, SEED, seconds, trace, torch.device("cpu"), control=control)
    result, checks = run.execute()
    return result, {c.name: c.value for c in checks}


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS["workloads"]])
def test_a_sound_run_is_correct(toy, cell):
    result, checks = execute(toy, cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("cell", [GATE, AUTH])
def test_the_control_is_not_correct(toy, cell):
    result, checks = execute(toy, cell, control=True)
    assert not result["correct"]
    assert max(checks.values()) > 0


def unchanged(orig):
    """A bootstrap that returns its input."""
    return lambda ck, ct, mu: ct


def half_batch(orig):
    """A bootstrap of the first half of the rows, the rest copied from it."""
    def fn(ck, ct, mu):
        rows = ct.b.shape[0]
        h = (rows + 1) // 2
        out = orig(ck, ct[:h], mu)
        idx = torch.arange(rows) % h
        return type(out)(out.a[idx], out.b[idx])
    return fn


def altered(orig):
    """A bootstrap whose answer in one row, drawn anew each call, is altered."""
    gen = torch.Generator().manual_seed(0)

    def fn(ck, ct, mu):
        out = orig(ck, ct, mu)
        row = int(torch.randint(0, out.b.shape[0], (), generator=gen))
        b = out.b.clone()
        b[row] += 1 << 20
        return type(out)(out.a, b)
    return fn


@pytest.mark.parametrize("cell", [GATE, AUTH])
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_a_fault_under_the_timed_path_is_not_correct(toy, monkeypatch, cell, fault):
    from peba1_tpu_torch.ops import bootstrap as bs
    monkeypatch.setattr(bs, "bootstrap", fault(bs.bootstrap))
    result, checks = execute(toy, cell)
    assert not result["correct"], checks
    assert result["failed"] >= 1


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """A short run of each cell on the card at its own sizes: correct, with
    every end-to-end metric the cell reports."""
    for cell in CELLS["workloads"]:
        run = run_mod.Run(ROOT, cell["name"], SEED, 2.0, False, card)
        result, checks = run.execute()
        assert result["correct"], checks
        want = {m["name"] for m in CELLS["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
        assert set(result["metrics"]) == want


def test_jax_loaded_after_the_window_refuses_the_result(toy, monkeypatch, capsys):
    """A metric reader, run once the window has closed, that loads JAX: the
    run exits non-zero and prints no result."""
    import sys
    (toy / "perfbench" / "metrics" / "device.idle_pct.gate.py").write_text(
        'import sys\nimport types\n\nLAYER = "device"\nUNIT = "%"\nMOVES = "bootstraps_per_s"\n\n\n'
        'def read(r):\n    sys.modules["jax"] = types.ModuleType("jax")\n    return 1.0\n')
    monkeypatch.chdir(toy)
    monkeypatch.setattr(run_mod, "card", lambda chips: torch.device("cpu"))
    saved = sys.modules.pop("jax", None)
    try:
        rc = run_mod.main(["--workload", GATE, "--seed", str(SEED), "--seconds", "1.5",
                           "--trace", "1"])
        planted = "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved
    assert planted
    assert rc != 0
    assert capsys.readouterr().out == ""
