"""The readings that the limits of `correct` are set from, on the card.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, in one process: a sound run of the cell (the lower reading)
and a run of its control (the upper reading), the program's own path with
the bootstrapping key's body one 8-bit limb shorter than the configuration
states, judged by the same reference.  Prints one JSON line a run with the
numbers compared.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .run import Run, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in (False, True):
            run = Run(os.getcwd(), args.workload, seed, args.seconds, False,
                      torch.device("cuda", 0), control=control)
            result, _ = run.execute()
            log(f"{'control' if control else 'sound'} seed {seed} done")
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              "correct": result["correct"], "attempted": result["attempted"],
                              "failed": result["failed"], "checks": result["checks"]}),
                  flush=True)
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
