"""What a run loads: never JAX or the JAX package (compared by whole
top-level names: the port, peba1_tpu_torch, is not peba1_tpu); the reference
nothing of the program either."""

import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(*modules) -> set:
    code = PROBE.format(imports="\n".join(f"import {m}" for m in modules))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    from perfbench.run import FORBIDDEN
    kinds = [f"perfbench.kinds.{p.stem}" for p in (ROOT / "perfbench" / "kinds").glob("*.py")
             if p.stem != "__init__"]
    top = loaded("perfbench.run", "perfbench.port", "perfbench.checks", "perfbench.trace",
                 *kinds)
    assert "peba1_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = loaded("perfbench.reference.tfhe", "perfbench.reference.peba1", "perfbench.material",
                 "perfbench.roofline")
    assert not top & {"peba1_tpu", "peba1_tpu_torch", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "peba1_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_without_the_program_a_run_exits_non_zero_with_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
