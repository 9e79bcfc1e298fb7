"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (its `file`), a traffic mix
(`perfbench/traffic/<traffic>.json`, whose `kind` names the general
generator in `perfbench/kinds/`) and, through the metrics that list it or
list no cells, the per-layer readers (`perfbench/metrics/<metric>.py`).
Adding a configuration, a mix of an existing kind or a per-layer metric adds
files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Spec:
    root: Path
    bench: dict

    @classmethod
    def load(cls, root) -> "Spec":
        root = Path(root)
        with open(root / "BENCHMARK.json") as f:
            return cls(root, json.load(f))

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                with open(self.root / entry["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.root / "perfbench" / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics_of(self, section: str, cell: str) -> "list[dict]":
        """The metrics of `section` ("end_to_end" or "per_layer") that the
        cell reports: those that list it, and those that list no cells."""
        return [m for m in self.bench[section] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The per-layer metric's reader module, loaded from its file."""
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def kind(traffic: dict):
    """The module of the traffic's general generator."""
    return importlib.import_module(f"perfbench.kinds.{traffic['kind']}")
