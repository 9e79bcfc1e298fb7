"""BENCHMARK.json against the contract's rules, and the harness's lookup by
name: what a cell names resolves, and a later change adds a configuration,
a traffic mix or a per-layer metric as new files and entries only."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from perfbench import spec as spec_mod

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])


def test_names_and_units_use_the_allowed_characters():
    names = [e["name"] for s in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[s]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert spec_mod.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec_mod.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for s in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[s]}) == len(BENCH[s])


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"])


def test_every_cell_resolves_and_reports_what_it_must():
    spec = spec_mod.Spec.load(ROOT)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert spec.config(cell["config"])["name"] == cell["config"]
        traffic = spec.traffic(cell["traffic"])
        assert spec_mod.kind(traffic).Workload
        reported = {m["name"] for m in spec.metrics_of("end_to_end", w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.metrics_of("per_layer", w["name"])
        assert layer
        for m in layer:
            # The metric moves an end-to-end metric that this cell reports.
            assert m["moves"] in reported, (m["name"], w["name"])
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_file_declares_its_layer_unit_and_moves(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = spec_mod.Spec.load(ROOT).reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (entry["layer"], entry["unit"],
                                                        entry["moves"])


def test_a_later_change_adds_files_and_entries_only(tmp_path):
    """A toy configuration, traffic mix and per-layer metric, as a later
    change would add them: new files beside the committed ones (copied
    unchanged) and new entries; the new cell resolves by name."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "perfbench" / "configs" / "peba1_tfhe128.json").read_text())
    cfg["name"] = "toy_tfhe"
    cfg["tfhe"].update(n=32, N=128)
    (tmp_path / "perfbench" / "configs" / "toy_tfhe.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "gate_chain_b8192.json").read_text())
    traffic["rows"] = 760
    (tmp_path / "perfbench" / "traffic" / "gate_chain_b760.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench" / "metrics" / "gate.calls.py").write_text(
        'LAYER = "bootstrap"\nUNIT = "calls"\nMOVES = "bootstraps_per_s"\n\n\n'
        "def read(r):\n    return r.bootstrap_calls or None\n")
    bench["configs"].append({"name": "toy_tfhe", "source": "https://github.com/tfhe/tfhe",
                             "file": "perfbench/configs/toy_tfhe.json", "reduced": ["n", "N"],
                             "why": "toy"})
    bench["workloads"].append({"name": "gate_toy_b760", "config": "toy_tfhe",
                               "traffic": "gate_chain_b760", "chips": 1, "why": "toy"})
    for m in bench["end_to_end"]:
        if m["name"] in ("bootstraps_per_s", "gate_call_p90_ms"):
            m["workloads"].append("gate_toy_b760")
    bench["per_layer"].append({"name": "gate.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "bootstrap",
                               "moves": "bootstraps_per_s", "workloads": ["gate_toy_b760"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = spec_mod.Spec.load(tmp_path)
    cell = spec.cell("gate_toy_b760")
    assert spec.config(cell["config"])["tfhe"]["N"] == 128
    assert spec.traffic(cell["traffic"])["rows"] == 760
    assert [m["name"] for m in spec.metrics_of("per_layer", "gate_toy_b760")] == ["gate.calls"]
    assert spec.reader("gate.calls").MOVES == "bootstraps_per_s"
    after = {p: (tmp_path / p).read_bytes() for p in before}
    assert after == before
