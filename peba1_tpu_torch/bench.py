"""Headline benchmark of the port: gate bootstraps per second on one card.

Counterpart of the repository's root ``bench.py``.  Runs chained batched
AND(x, x) bootstraps (each output feeds the next gate, so the bootstraps are
serialized as a circuit's are) at B rows, on ``peba1_128_t2_gen`` by default,
decrypts the chained output and prints ONE JSON line:

  {"metric": "gate_bootstraps_per_s_per_chip", "value": ..., ...}

The rate is the delta of two chain lengths, (t(S2) - t(S1)) / (S2 - S1) for
B bootstraps, which cancels what a run pays once (encryption is outside the
clock; the first call of each length, which builds the kernels, is a
warm-up on its own inputs).  Each length is timed `reps` times on fresh
encryptions, each run between two torch.cuda.synchronize() calls, and its
minimum taken.  `vs_baseline` is against 10^4 bootstraps/s.

    python -m peba1_tpu_torch.bench                          # the card
    python -m peba1_tpu_torch.bench --params toy --batch 64 --device cpu

Settings come from PEBA1_BENCH_BATCH, _S1, _S2, _REPS and _PARAMS (defaults
8192, 2, 10, 2, peba1_128_t2_gen), each overridden by its flag.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import gates, keys, lwe
from .ops import bootstrap as bs
from .params import PRESETS
from .utils import device as devinfo


def chain(ck, ct: lwe.Lwe, steps: int) -> lwe.Lwe:
    """`steps` serialized identity bootstraps: AND(x, x) = x."""
    for _ in range(steps):
        pre = lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8)
        ct = bs.bootstrap(ck, pre, gates.MU_1_8)
    return ct


def time_chains(sk, ck, bits: np.ndarray, lengths, reps: int,
                gen: torch.Generator) -> "tuple[dict, lwe.Lwe]":
    """Seconds of `chain(ck, ct, s)` for each chain length s: one warm-up on
    its own encryption, then the minimum of `reps` runs on fresh encryptions,
    each between two synchronizations.  Returns ({s: seconds}, the last
    run's output at the longest length)."""
    dev = sk.device
    ts, out = {}, None
    for s in lengths:
        chain(ck, gates.encrypt_bits(gen, sk, bits), s)
        best = float("inf")
        for _ in range(reps):
            ct = gates.encrypt_bits(gen, sk, bits)
            devinfo.sync(dev)
            t0 = time.perf_counter()
            out = chain(ck, ct, s)
            devinfo.sync(dev)
            best = min(best, time.perf_counter() - t0)
        ts[s] = best
    return ts, out


def parse_args(argv=None) -> argparse.Namespace:
    env = os.environ.get
    ap = argparse.ArgumentParser(description="gate bootstraps/s on one card")
    ap.add_argument("--batch", type=int, default=int(env("PEBA1_BENCH_BATCH", "8192")))
    ap.add_argument("--s1", type=int, default=int(env("PEBA1_BENCH_S1", "2")))
    ap.add_argument("--s2", type=int, default=int(env("PEBA1_BENCH_S2", "10")))
    ap.add_argument("--reps", type=int, default=int(env("PEBA1_BENCH_REPS", "2")))
    ap.add_argument("--params", default=env("PEBA1_BENCH_PARAMS", "peba1_128_t2_gen"),
                    choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not args.s2 > args.s1 >= 1 or args.reps < 1:
        ap.error(f"need S2 > S1 >= 1 and REPS >= 1, got S1={args.s1} S2={args.s2} "
                 f"REPS={args.reps}")
    return args


def main(argv=None, keyset=None) -> dict:
    """Run the benchmark and print its JSON line; returns the record.
    `keyset`, a (secret key, cloud key) pair at --params on --device, skips
    keygen."""
    args = parse_args(argv)
    device = devinfo.require(args.device)
    params = PRESETS[args.params]
    if keyset is None:
        keyset = keys.keygen(torch.Generator(device=device).manual_seed(0), params, device)
    sk, ck = keyset
    if ck.params != params or sk.device != device:
        raise ValueError(f"the keyset given is not at {args.params} on {device}")
    bits = np.random.default_rng(0).integers(0, 2, args.batch)
    gen = torch.Generator(device=device).manual_seed(1)
    S1, S2 = args.s1, args.s2
    ts, out = time_chains(sk, ck, bits, (S1, S2), args.reps, gen)
    if not ts[S2] > ts[S1]:
        raise RuntimeError(f"timing implausible: t(S2={S2})={ts[S2]:.3f}s <= "
                           f"t(S1={S1})={ts[S1]:.3f}s")
    dt = (ts[S2] - ts[S1]) / (S2 - S1)
    value = args.batch / dt
    got = gates.decrypt_bits(out, sk).cpu().numpy()
    rec = {
        "metric": "gate_bootstraps_per_s_per_chip",
        "value": value,
        "unit": "bootstraps/s",
        "vs_baseline": value / 10_000.0,
        "batch": args.batch,
        "chain_lengths": [S1, S2],
        "ms_per_batch": dt * 1e3,
        "t_s1": ts[S1],
        "t_s2": ts[S2],
        "batch_correct_frac": float((got == bits).mean()),
        "params": args.params,
        "device": devinfo.name(device),
        "power_limit": devinfo.power_limit(device),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
