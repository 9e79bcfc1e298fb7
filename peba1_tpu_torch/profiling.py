"""Per-batch timings of the bootstrap paths on the card, and device profiles.

    python -m peba1_tpu_torch.profiling

For each batch size B in `BATCHES` it prints one JSON line per path, each
time the mean of a few calls after a warm-up, timed with CUDA events:
  * `peba1_128_t2_gen`: a CMUX step (`ops/cuda_kernels.cmux_step_gen` over
    `GEN_STEPS` steps of the cloud key in one call, divided by the steps),
    the same step as a call of its own (one launch a step), one keyswitch
    and one whole bootstrap call;
  * `peba1_128_t2`: a CMUX step against the precomputed weights
    (`cuda_kernels.cmux_step` over `GEN_STEPS` steps of ``bk_w`` in one
    call, divided by the steps) and the same step as a call of its own;
  * `peba1_128_fast_genf`: one whole blind rotation
    (`cuda_kernels.blind_rotate_gen_full`, all n steps in one launch) and one
    whole bootstrap call;
  * `peba1_128_fast` with `use_fused_cmux` (`FAST_FUSED`, the parameters of
    the 1:N sweep path): the same two, the rotation being
    `cuda_kernels.fused_blind_rotate` against the A-matrix key.
After the t2_gen, fast_genf and fused lines, `torch.profiler` traces two bootstrap
calls at `PROFILE_BATCH`, the authentication's mean rows per bootstrap call,
and prints each kernel's share of the device time and the device's busy
share of the host wall time.  The first line is the card's name and power
limit as nvidia-smi gives them.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from . import gates, keys, lwe
from .driver import generator
from .ops import bootstrap as bs
from .ops import cuda_kernels
from .params import PRESETS

FAST_FUSED = dataclasses.replace(PRESETS["peba1_128_fast"], use_fused_cmux=True)
BATCHES = (32, 128, 184, 512, 1024, 2048, 4096, 8192)
PROFILE_BATCH = 184
# Steps of one timed cmux_step_gen or cmux_step call: each kernel runs a
# call's steps in one cooperative launch, whose start and barriers one step
# would carry alone; a bootstrap call runs n = 630.
GEN_STEPS = 8
SEED = 0


def mean_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds of fn() over reps calls after one warm-up call,
    timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _rand_i32(rng, shape, device) -> torch.Tensor:
    return torch.as_tensor(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                           .astype(np.int32), device=device)


def _ciphertexts(sk, B: int, device: torch.device, seed: int) -> lwe.Lwe:
    rng = np.random.default_rng(seed + B)
    return gates.encrypt_bits(generator(device, seed + B), sk, rng.integers(0, 2, B))


def t2_gen_times(ck, sk, B: int, device: torch.device, seed: int) -> dict:
    p = ck.params
    rng = np.random.default_rng(seed + B)
    ct = _ciphertexts(sk, B, device, seed)
    acc = _rand_i32(rng, (B, (p.k + 1) * p.N), device)
    amt = torch.as_tensor(rng.integers(0, 2 * p.N, (GEN_STEPS, B), dtype=np.int32),
                          device=device)
    a_ext = _rand_i32(rng, (B, p.k * p.N), device)
    b_ext = a_ext[:, 0].clone()
    return {"B": B,
            "cmux_step_ms": mean_ms(
                lambda: cuda_kernels.cmux_step_gen(acc, amt, ck.bk_tp[:GEN_STEPS], p),
                5, device) / GEN_STEPS,
            "cmux_step_alone_ms": mean_ms(
                lambda: cuda_kernels.cmux_step_gen(acc, amt[:1], ck.bk_tp[:1], p),
                5, device),
            "keyswitch_ms": mean_ms(lambda: bs.keyswitch(ck, a_ext, b_ext), 5, device),
            "bootstrap_ms": mean_ms(lambda: bs.bootstrap(ck, ct, gates.MU_1_8),
                                    2, device)}


def t2_w_times(ck, B: int, device: torch.device, seed: int) -> dict:
    p = ck.params
    rng = np.random.default_rng(seed + B)
    acc = _rand_i32(rng, (B, (p.k + 1) * p.N), device)
    amt = torch.as_tensor(rng.integers(0, 2 * p.N, (GEN_STEPS, B), dtype=np.int32),
                          device=device)
    return {"B": B,
            "cmux_step_ms": mean_ms(
                lambda: cuda_kernels.cmux_step(acc, amt, ck.bk_w[:GEN_STEPS], p),
                5, device) / GEN_STEPS,
            "cmux_step_alone_ms": mean_ms(
                lambda: cuda_kernels.cmux_step(acc, amt[:1], ck.bk_w[:1], p), 5, device)}


def rotation_times(ck, sk, B: int, device: torch.device, seed: int) -> dict:
    """One whole blind rotation through the parameters' whole-rotation kernel
    (`blind_rotate_gen_full` on bk_tp or `fused_blind_rotate` on bk_amat),
    and one bootstrap call."""
    p = ck.params
    rng = np.random.default_rng(seed + B)
    ct = _ciphertexts(sk, B, device, seed)
    amt = torch.as_tensor(rng.integers(0, 2 * p.N, (p.n + 1, B), dtype=np.int32),
                          device=device)
    kernel, key = ((cuda_kernels.fused_blind_rotate, ck.bk_amat) if p.use_fused_cmux
                   else (cuda_kernels.blind_rotate_gen_full, ck.bk_tp))
    return {"B": B,
            "blind_rotate_ms": mean_ms(lambda: kernel(amt, key, gates.MU_1_8, p), 2, device),
            "bootstrap_ms": mean_ms(lambda: bs.bootstrap(ck, ct, gates.MU_1_8),
                                    2, device)}


def profile(ck, sk, B: int, device: torch.device, seed: int) -> dict:
    """Device time per kernel over two bootstrap calls at batch B."""
    ct = gates.encrypt_bits(generator(device, seed), sk,
                            np.random.default_rng(seed).integers(0, 2, B))
    bs.bootstrap(ck, ct, gates.MU_1_8)                       # warm-up
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            ct = bs.bootstrap(ck, lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8),
                              gates.MU_1_8)
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    for evt in prof.key_averages():
        # Only the device's own events: an operator's device time repeats
        # that of the kernels it launched.
        us = evt.self_device_time_total
        if evt.device_type == DeviceType.CUDA and us > 0:
            per_kernel[evt.key] = (us, evt.count)
    busy = sum(us for us, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"profile_B": B, "calls": 2, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if wall_us else 0.0,
            "kernels": [{"name": name[:80], "share": us / busy, "launches": n,
                         "us_per_launch": us / n}
                        for name, (us, n) in top]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
        flush=True)
    paths = {"peba1_128_t2_gen": PRESETS["peba1_128_t2_gen"],
             "peba1_128_t2": PRESETS["peba1_128_t2"],
             "peba1_128_fast_genf": PRESETS["peba1_128_fast_genf"],
             "peba1_128_fast_fused": FAST_FUSED}
    for name, params in paths.items():
        sk, ck = keys.keygen(generator(device, SEED), params, device)
        for B in BATCHES:
            if name == "peba1_128_t2":
                times = t2_w_times(ck, B, device, SEED)
            elif name == "peba1_128_t2_gen":
                times = t2_gen_times(ck, sk, B, device, SEED)
            else:
                times = rotation_times(ck, sk, B, device, SEED)
            print(json.dumps({"params": name, **times}), flush=True)
        if name != "peba1_128_t2":
            print(json.dumps({"params": name,
                              **profile(ck, sk, PROFILE_BATCH, device, SEED)}), flush=True)
        del sk, ck
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
