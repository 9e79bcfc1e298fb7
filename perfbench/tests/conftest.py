"""Tests of the benchmark harness.  Run from the repository's root:

    python -m pytest perfbench/tests -q

They import no JAX.  Those marked `cuda` need an NVIDIA card and skip
elsewhere; the rest run on the CPU at toy sizes.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# Toy sizes of the two configurations and of the protocol: every width the
# scheme reads, scaled down so that the plain path runs on the CPU in
# seconds.
TOY_TFHE = {"n": 32, "N": 128}
TOY_PROTOCOL = {"nslots": 2, "bitsize": 3, "max_bitsize": 9, "mul_width": 8,
                "bound_match": 4}
TOY_GATE = {"rows": 64}
# The kinds' check sizes and traced slices at toy sizes.
TOY_CONSTANTS = {"gate_chain": {"CHECK_ROWS": 8, "FULL_CALL_WITHIN": 3, "TRACE_CALLS": (1, 2)},
                 "auth_closed": {"CHECK_CALLS": 8, "TRACE_CALLS": (5, 10)}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def toy_root(tmp_path: Path) -> Path:
    """A checkout root holding the benchmark at toy sizes: BENCHMARK.json as
    committed, each configuration and traffic file scaled down, the metric
    readers as committed."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "perfbench" / "traffic").mkdir(parents=True)
    (tmp_path / "perfbench" / "configs").mkdir()
    shutil.copytree(ROOT / "perfbench" / "metrics", tmp_path / "perfbench" / "metrics")
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["tfhe"].update(TOY_TFHE)
        cfg["protocol"].update(TOY_PROTOCOL)
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for name in {w["traffic"] for w in bench["workloads"]}:
        t = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
        if t["kind"] == "gate_chain":
            t.update(TOY_GATE)
        (tmp_path / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def toy(tmp_path, monkeypatch):
    import importlib
    for kind, constants in TOY_CONSTANTS.items():
        module = importlib.import_module(f"perfbench.kinds.{kind}")
        for name, value in constants.items():
            monkeypatch.setattr(module, name, value)
    return toy_root(tmp_path)
