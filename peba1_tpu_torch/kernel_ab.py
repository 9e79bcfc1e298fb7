"""Kernel times of two source trees on one card, in turns.

    python -m peba1_tpu_torch.kernel_ab --parent build/parent   # parent, change, change, parent
    python -m peba1_tpu_torch.kernel_ab                         # this tree once

Each turn is a fresh process started in one tree's root, which builds that
tree's kernels and runs its ``chip_smoke.kernel_case`` on every case of
`CASES` (each kernel against its plain twin, then CUDA-event times: `ms`,
calls in a row, and `device_ms`, on the card alone) and this file's
`host_us` (the wrapper's host time a call), then times whole bootstrap
calls of `BOOTSTRAP_CASES` through that tree's package with this file's
`bootstrap_calls`; the code of this file times both trees alike.  The
parent is another checkout of the repository (for example
``git archive <commit> | tar -x -C build/parent``).  Prints the card's name
and power limit first, then one JSON line per turn and case, then one line
per case with the readings of every turn side by side.  A case that
disagrees with its twin, or a bootstrap call that decrypts wrong, fails
the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

# (kernel, preset or chip_smoke.params_of() label, batch, steps): the
# kernels on csrc/whole_rotation.cuh at the sweep's (760) and the
# authentication's (184) rows and at 8,192 (kernel 1 also at ring_2048_gen,
# kernel 4 also at peba1_128_fast), kernel 5 at 8,192 and 1,000 rows, and
# every smoke case of kernel 3; then the benchmark cells' lattices: kernel 2
# at TFHE v1.x's (an authentication's calls of 1 to 512 rows and 8,192) and
# kernel 1 at tfhers_bool_gen.  Labels are resolved by this tree's
# chip_smoke.params_of in both turns, so a parent that lacks a label runs
# it all the same.
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
    ("rotate_decompose", "peba1_128_t2", 2048, 1),
    ("rotate_decompose", "peba1_128_t2", 1000, 1),
    ("rotate_decompose", "peba1_128_t2", 184, 1),
    ("rotate_decompose", "peba1_128_fast", 8192, 1),
    ("rotate_decompose", "peba1_128_fast", 1000, 1),
    ("rotate_decompose", "peba1_128_fast", 67, 1),
    ("cmux_step", "peba1_128_t2", 8192, 8),
    ("cmux_step", "peba1_128_t2", 760, 8),
    ("cmux_step", "peba1_128_t2", 184, 8),
    ("cmux_step", "peba1_128_fast", 1000, 8),
    ("extprod_recombine", "peba1_128_t2", 8192, 1),
    ("extprod_recombine", "peba1_128_t2", 1000, 1),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 8192, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 512, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 256, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 128, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 16, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 1, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 8192, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 128, 8),
)
# (preset or label of `EXTPROD`, batches): whole bootstrap calls of the
# paths that call a kernel once a CMUX step: w_streaming (cmux_step, W
# built from bk_tp each step) at the authentication's rows and at 8,192;
# the scan's rotate_decompose before the float64 GEMM (peba1_128_fast) and
# before extprod_recombine at the smoke chains' 2,048 rows.
BOOTSTRAP_CASES = (("peba1_128_t2_stream", (184, 8192)), ("peba1_128_fast", (2048,)),
                   ("peba1_128_t2_extprod", (2048,)))
EXTPROD = "peba1_128_t2_extprod"    # peba1_128_t2 with use_pallas_extprod (no preset)

_TURN = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
spec = importlib.util.spec_from_file_location("kernel_ab_here", {here!r})
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
spec = importlib.util.spec_from_file_location("chip_smoke_here", {smoke!r})
smoke_here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke_here)
chip_smoke.params_of = smoke_here.params_of
device = torch.device("cuda", 0)
for kernel, params, B, steps in {cases!r}:
    case = chip_smoke.kernel_case(kernel, params, B, steps, device, timed=True)
    case["host_us"] = ab.host_us(chip_smoke, kernel, params, B, steps, device)
    print(json.dumps(case), flush=True)
for params, batches in {calls!r}:
    for case in ab.bootstrap_calls(params, batches, device):
        print(json.dumps(case), flush=True)
"""


def host_us(smoke, kernel: str, params: str, B: int, steps: int, device,
            batches: int = 5, reps: int = 40) -> float:
    """Microseconds of host time a call of `kernel`'s wrapper, on `smoke`'s
    inputs of the case: the median over `batches` batches of `reps` calls,
    each batch enqueued while the card sleeps (so the card runs none of them
    before the batch ends) and timed by the host's clock.  The median, since
    the host's clock catches whatever else its shared cores run."""
    import statistics
    import time
    import torch
    from peba1_tpu_torch.ops import cuda_kernels
    args, *_ = smoke._inputs(kernel, smoke.params_of(params), B, steps, device, 0)
    wrapper = getattr(cuda_kernels, kernel)
    wrapper(*args)                                                  # warm-up
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize(device)
        torch.cuda._sleep(200_000_000)      # about 0.1 s, far longer than a batch
        t0 = time.perf_counter()
        for _ in range(reps):
            wrapper(*args)
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize(device)
    return statistics.median(per_call)


def bootstrap_calls(params: str, batches, device, reps: int = 3) -> "list[dict]":
    """Milliseconds of one bootstrap call at preset `params` for each batch,
    the mean of `reps` calls after a warm-up (CUDA events), on a key from
    seed 0 in the package found first on ``sys.path``, with the CUDA
    launches of one call and the bits it decrypts wrong."""
    import numpy as np
    import torch
    from peba1_tpu_torch import gates, keys
    from peba1_tpu_torch.ops import bootstrap as bs
    from peba1_tpu_torch.ops import cuda_kernels
    from peba1_tpu_torch.params import PRESETS
    p = (dataclasses.replace(PRESETS["peba1_128_t2"], use_fused_step=False,
                             use_pallas_extprod=True)
         if params == EXTPROD else PRESETS[params])
    sk, ck = keys.keygen(torch.Generator(device=device).manual_seed(0), p, device)
    out = []
    for B in batches:
        bits = np.random.default_rng(B).integers(0, 2, B)
        ct = gates.encrypt_bits(torch.Generator(device=device).manual_seed(B), sk, bits)
        bs.bootstrap(ck, ct, gates.MU_1_8)                          # warm-up
        torch.cuda.synchronize(device)
        cuda_kernels.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            res = bs.bootstrap(ck, ct, gates.MU_1_8)
        end.record()
        torch.cuda.synchronize(device)
        wrong = int((gates.decrypt_bits(res, sk).cpu().numpy() != bits).sum())
        out.append({"kernel": "bootstrap_call", "params": params, "B": B,
                    "ms": start.elapsed_time(end) / reps, "mismatches": wrong,
                    "launches": {k: v // reps for k, v in cuda_kernels.launches.items() if v}})
    return out


def turn(root: str, cases=CASES, calls=BOOTSTRAP_CASES) -> "list[dict]":
    """One process in `root`: its kernel_case of every case, then the
    bootstrap calls."""
    here = os.path.abspath(__file__)
    smoke = os.path.join(os.path.dirname(os.path.dirname(here)), "chip_smoke.py")
    script = _TURN.format(root=root, here=here, smoke=smoke, cases=list(cases),
                          calls=list(calls))
    proc = subprocess.run([sys.executable, "-c", script],
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
            readings.setdefault(key, []).append((label, case))
    for (kernel, params, B), turns in readings.items():
        print(json.dumps({"kernel": kernel, "params": params, "B": B,
                          "turns": [t for t, _ in turns],
                          **{k: [c.get(k) for _, c in turns]
                             for k in ("ms", "device_ms", "host_us")}}), flush=True)


if __name__ == "__main__":
    main()
