"""One run of one benchmark cell of ``peba1_tpu_torch`` on NVIDIA cards.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix and
metrics are read from ``BENCHMARK.json`` and the files it names.  Set-up
makes the raw keys from the seed on the card, hands them to the program,
makes the traffic's inputs and warms every shape the traffic uses; then the
window measures for `--seconds`; then the program's state is freed and the
plain reference (``perfbench/reference``) judges what the window produced.

The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device` and, with `--trace 1`, `breakdown`; the numbers
compared and their limits come last, under `checks`, and as the last lines
of standard error.  Exits non-zero with no result where no card (or fewer
than the cell asks for) is available, where the program cannot be imported,
or where JAX or the JAX package was loaded: checked when the window has
closed and again just before the result is printed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()          # process start, as near as Python gets

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "peba1_tpu")


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader may read."""

    config: dict
    traffic: dict
    call_ms: list = dataclasses.field(default_factory=list)   # device ms a call
    rows: int = 0                    # rows a bootstrap call (gate chains)
    request_s: list = dataclasses.field(default_factory=list)
    bootstrap_calls: int = 0
    trace: object = None             # perfbench.trace.Slice, or None


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    def __init__(self, root, workload: str, seed: int, seconds: float, trace: bool,
                 device, control: bool = False):
        from . import spec as spec_mod
        from .reference.tfhe import Lattice
        self.spec = spec_mod.Spec.load(root)
        self.cell = self.spec.cell(workload)
        self.config = self.spec.config(self.cell["config"])
        self.traffic = self.spec.traffic(self.cell["traffic"])
        self.lat = Lattice.of(self.config["tfhe"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control = device, control
        self.kind = spec_mod.kind(self.traffic)

    def program_config(self) -> dict:
        """The configuration the program runs: as stated, or for the control
        with the bootstrapping key's body one 8-bit limb shorter."""
        if not self.control:
            return self.config
        tfhe = dict(self.config["tfhe"], bk_body_limbs=self.config["tfhe"]["bk_body_limbs"] - 1)
        return dict(self.config, tfhe=tfhe)

    def seed_of(self, part: str) -> int:
        from .material import seeds
        return dict(zip(("keys", "traffic"), seeds(self.seed, 2)))[part]

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def execute(self) -> "tuple[dict, list]":
        """Set-up, window, judgement: (result, checks)."""
        import torch

        from . import checks, material, port
        from .trace import Tracer
        stages = {"start": time.perf_counter() - T0}
        self.keys = material.make_keys(self.lat, material.generator(self.device,
                                                                    self.seed_of("keys")))
        self.sync()
        stages["keys"] = time.perf_counter() - T0
        self.sk, self.ck = port.load_keys(port.params(self.program_config()), self.keys,
                                          self.device)
        self.sync()
        stages["program_keys"] = time.perf_counter() - T0
        self.tracer = Tracer(self.trace, *self.kind.TRACE_CALLS)
        self.tracer.warm()
        work = self.kind.Workload(self)
        work.setup()
        self.sync()
        setup_s = time.perf_counter() - T0
        stages["traffic"] = setup_s
        log(f"set-up {setup_s:.3f} s, ended at (s): {json.dumps(stages)}")
        outcome = work.window(self.seconds, self.tracer)
        self.tracer.close()
        log(f"window {json.dumps(outcome)}")
        cuda = self.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"perfbench: the window loaded {', '.join(found)}")
        work.release()
        self.sk = self.ck = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sliced = self.tracer.reduce()
        t1 = time.perf_counter()
        judged, attempted, failed = work.check(checks.Reference(self.lat, self.keys))
        self.sync()
        log(f"trace read in {t1 - t0:.3f} s, reference check {time.perf_counter() - t1:.3f} s")
        readings = Readings(self.config, self.traffic, trace=sliced,
                            **work.readings())
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(self.device) if cuda else "cpu",
                  "count": int(self.cell["chips"]), "memory_peak_bytes": int(peak)}
        result = {"correct": all(c.ok for c in judged), "attempted": attempted,
                  "failed": failed, "metrics": self._metrics(outcome, setup_s, readings),
                  "device": device}
        if self.trace and sliced is not None:
            device.update(busy_s=sliced.busy_s, window_s=sliced.window_s)
            result["breakdown"] = {"device_ops": sliced.device_ops,
                                   "idle_gaps": sliced.idle_gaps}
        result["checks"] = checks.as_json(judged)
        return result, judged

    def _metrics(self, outcome: dict, setup_s: float, readings: Readings) -> dict:
        name = self.cell["name"]
        out = {}
        if not self.trace:
            for m in self.spec.metrics_of("end_to_end", name):
                value = setup_s if m["name"] == "setup_s" else outcome.get(m["name"])
                if value is not None:
                    out[m["name"]] = {"value": value, "unit": m["unit"]}
            return out
        for m in self.spec.metrics_of("per_layer", name):
            value = self.spec.reader(m["name"]).read(readings)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def card_label() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def card(chips: int):
    """The first CUDA device where at least `chips` are available, else None."""
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        return torch.device("cuda", 0)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from . import spec as spec_mod
    try:
        chips = int(spec_mod.Spec.load(os.getcwd()).cell(args.workload)["chips"])
    except (OSError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    device = card(chips)
    if device is None:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        import peba1_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program (peba1_tpu_torch) cannot be imported: {e}",
              file=sys.stderr)
        return 2
    log(f"{card_label()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    run = Run(os.getcwd(), args.workload, args.seed, args.seconds, bool(args.trace), device)
    result, judged = run.execute()
    # Again now that the trace, the reference and the metric readers have
    # run: nothing loaded since the window may bring JAX in either.
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    from .checks import lines
    for line in lines(judged):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
