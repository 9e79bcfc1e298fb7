"""Kernel times of two source trees on one card, in turns.

    python -m peba1_tpu_torch.kernel_ab --parent build/parent   # parent, change, change, parent
    python -m peba1_tpu_torch.kernel_ab                         # this tree once

Each turn is a fresh process started in one tree's root, which builds that
tree's kernels and runs its ``chip_smoke.kernel_case`` on every case of
`CASES` (each kernel against its plain twin, then CUDA-event times).  The
parent is another checkout of the repository (for example
``git archive <commit> | tar -x -C build/parent``).  Prints the card's name
and power limit first, then one JSON line per turn and case, then one line
per case with the readings of every turn side by side.  A case that
disagrees with its twin fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (kernel, preset or chip_smoke.fused_params() label, batch, steps): the
# kernels on csrc/whole_rotation.cuh at the sweep's (760) and the
# authentication's (184) rows and at 8,192 (kernel 1 also at ring_2048_gen),
# and the other kernels at their largest smoke case.
CASES = (
    ("fused_blind_rotate", "peba1_128_fast_fused", 8192, 8),
    ("fused_blind_rotate", "peba1_128_fast_fused", 760, 8),
    ("fused_blind_rotate", "peba1_128_fast_fused", 184, 8),
    ("fused_blind_rotate", "peba1_128_t2_fused", 8192, 8),
    ("fused_blind_rotate", "peba1_128_t2_fused", 760, 8),
    ("fused_blind_rotate", "peba1_128_t2_fused", 184, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 8192, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 760, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 184, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 8192, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 760, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 184, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 8192, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 760, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 184, 8),
    ("cmux_step_gen", "ring_2048_gen", 256, 8),
    ("rotate_decompose", "peba1_128_t2", 8192, 1),
    ("cmux_step", "peba1_128_t2", 8192, 2),
    ("extprod_recombine", "peba1_128_t2", 8192, 1),
)

_TURN = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
device = torch.device("cuda", 0)
for kernel, params, B, steps in {cases!r}:
    print(json.dumps(chip_smoke.kernel_case(kernel, params, B, steps, device, timed=True)),
          flush=True)
"""


def turn(root: str, cases=CASES) -> "list[dict]":
    """One process in `root`: its kernel_case of every case."""
    proc = subprocess.run([sys.executable, "-c", _TURN.format(root=root, cases=list(cases))],
                          cwd=root, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise SystemExit(f"turn in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of the parent tree (default: this tree once)")
    args = parser.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    order = ([("parent", args.parent), ("change", here), ("change", here),
              ("parent", args.parent)] if args.parent else [("change", here)])
    readings: "dict[tuple, list]" = {}
    for label, root in order:
        for case in turn(os.path.abspath(root)):
            print(json.dumps({"tree": label, **case}), flush=True)
            if case["mismatches"]:
                raise SystemExit(f"{label}: {case['kernel']} disagrees with its twin")
            key = (case["kernel"], case["params"], case["B"])
            readings.setdefault(key, []).append((label, case["ms"]))
    for (kernel, params, B), ms in readings.items():
        print(json.dumps({"kernel": kernel, "params": params, "B": B,
                          "turns": [t for t, _ in ms], "ms": [m for _, m in ms]}), flush=True)


if __name__ == "__main__":
    main()
