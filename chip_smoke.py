#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (peba1_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                     # every phase, one card

Builds the CUDA kernels from the sources in the checkout, then runs, each
phase printing one JSON line:
  1. device: card name, count, and nvidia-smi's name and power limit;
  2. build: every csrc/*.cu, one nvcc each, all at once; ptxas must report
     no register spill in any kernel;
  3. kernel: every kernel against its plain PyTorch twin, bit-equal, on
     seeded random inputs at the main paths' shapes (kernels 1 and 2 also at
     NARROW_MAX_ROWS rows or fewer, where they take the narrow step; each
     case's wrapper call makes one launch, and a narrow call exactly when
     its rows are that few), with CUDA-event times of
     the kernel (calls in a row, and on the card alone), of the twin and (for
     the GEMM kernels) of torch._int_mm on the same product, the bound of
     each case, and for rotate_decompose the time of a device-to-device copy
     of as many bytes (a ceiling it can reach; the port never calls either
     yardstick);
  4. gate and auth at peba1_128_t2_gen (the main path, one cmux_step_gen
     launch per bootstrap call): keygen on the card, a chain of serialized
     AND(x, x) bootstraps at B=8192 (bench.py's measurement), decrypted,
     cmux_step_gen bit-equal to its plain twin over the full n at the
     authentication's 184 rows, then full-width PEBA1 authentication
     (nslots=128, bitsize=8, bound 256), a genuine and an impostor request
     in one Server.authenticate call;
  5. the same at peba1_128_fast_genf (one blind_rotate_gen_full launch per
     bootstrap call), with the blind rotation bit-equal to the
     cmux_step_gen path on the same key at B=8192 and the full n;
  6. at peba1_128_t2 (one cmux_step launch per bootstrap call, against
     bk_w): a gate chain at B=8192, cmux_step bit-equal to its plain twin
     over the full n at 184 rows, the rotation bit-equal to the
     cmux_step_gen path on the same key at B=8192, and a gate chain on the
     same key with w_streaming (one cmux_step call a step, W built from
     bk_tp); then gate chains at peba1_128_fast (rotate_decompose and the
     float64 Toeplitz GEMM) and peba1_128_t2 with use_pallas_extprod
     (rotate_decompose and extprod_recombine);
  7. peba1_128_fast with use_fused_cmux (one fused_blind_rotate launch per
     bootstrap call, against the A-matrix key bk_amat): a gate chain at
     B=8192, the rotation bit-equal to the cmux_step_gen path on the same
     key at B=8192 and the full n, and a checkpointed 1:N identification
     sweep at full width (sweep.IdentifySweep: 4 templates, one a near
     match, in one chunk; probe and templates through io/wire frames), run
     a second time on the same directory, which resumes with 0 launches;
  8. the port's tools, in process, on the keysets above where they fit:
     bench (python -m peba1_tpu_torch.bench, chains of 1 and 2, its JSON
     line printed as it is) and bench_matches (argmin over 2 full-width
     templates) at peba1_128_t2_gen, diag campaign (8 chained steps at
     B=8192, no chain error) at peba1_128_fast_genf, and the sweep CLI at
     peba1_128_t2_gen and full width (2 templates, one a chunk: stopped
     after one chunk, resumed, then finalized on the CPU, which must launch
     nothing);
  9. the parallel layer (peba1_tpu_torch.parallel) at peba1_128_t2_gen on
     the keyset of phase 4, in a world of one rank on NCCL (mesh 1x1):
     sharded_bootstrap at B=8192 bit-equal to ops/bootstrap.bootstrap,
     launching cmux_step_gen, both timed in turns; sharded_bootstrap_ringtp
     with overlap_blocks 1 and 2 at 184 rows over the full n, bit-equal,
     launching nothing (its column product is plain float64, as in the JAX
     package), and the share of its time in the column products;
     sharded_identify at full width on two templates, one a near match;
     after phase 3, the exact NTT (ops/ntt.py) on the card at N=1024 and
     2048 against the naive product, and its round trip;
 10. the multi-rank dry run (python -m peba1_tpu_torch.dryrun, the
     counterpart of __graft_entry__.dryrun_multichip), in process, its ranks
     sharing the card over gloo: a world of 2 at toy (mesh 1x2, ring-TP
     over tp=2) and a world of 4 at peba1_128_t2_gen (mesh 2x2), every
     check passing (bootstrap bits, ring-TP with 1 and 2 blocks, identify
     verdicts, argmin index and distance), every rank of the second
     launching cmux_step_gen in sharded_bootstrap and gspmd_identify;
 11. the kernels line, then {"ok": true, "device": {...}} as the last line.
Every path's launch counts are set to 0 just before it runs and read just
after.  Any failure exits non-zero before the last line.  With no CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor-core ops, 2 per MAC
MU = -(1 << 29) + 12345      # test-vector amplitude of the kernel cases
# (kernel, preset or params_of() label, batch, steps): the shapes each
# kernel meets on its path; 184 and 760 are the authentication's and the
# sweep's mean rows a bootstrap call (757 rounded up to a multiple of 8, as
# torch._int_mm needs), 2048 the use_pallas_extprod chain's batch; 1 to
# 1,152 rows the calls of an authentication at the benchmark's TFHE v1.x
# lattice, whose steps end in a partial wave of work items; 1, 16 and 32
# rows the narrow step's instances of 1, 2 and 4 row groups of 8
# (cuda_kernels.NARROW_MAX_ROWS), at the lattices of the main paths.
KERNEL_CASES = (
    ("cmux_step_gen", "peba1_128_t2_gen", 8192, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 1000, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 760, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 184, 8),
    ("cmux_step_gen", "ring_2048_gen", 256, 8),
    ("cmux_step_gen", "ring_2048_gen", 8192, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 8192, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 184, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 1, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 16, 8),
    ("cmux_step_gen", "peba1_128_t2_gen", 32, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 1, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 16, 8),
    ("cmux_step_gen", "tfhers_bool_gen", 32, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 8192, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 1000, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 760, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 184, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 16, 8),
    ("blind_rotate_gen_full", "peba1_128_fast_genf", 32, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 8192, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 1000, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 760, 8),
    ("blind_rotate_gen_full", "peba1_128_t2_genf", 184, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 8192, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 1152, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 512, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 128, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 1, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 16, 8),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 32, 8),
    ("rotate_decompose", "peba1_128_t2", 8192, 1),
    ("rotate_decompose", "peba1_128_t2", 2048, 1),
    ("rotate_decompose", "peba1_128_t2", 1000, 1),
    ("rotate_decompose", "peba1_128_t2", 184, 1),
    ("rotate_decompose", "peba1_128_fast", 8192, 1),
    ("rotate_decompose", "peba1_128_fast", 1000, 1),
    ("rotate_decompose", "peba1_128_fast", 67, 1),
    ("cmux_step", "peba1_128_t2", 8192, 8),
    ("cmux_step", "peba1_128_t2", 1000, 8),
    ("cmux_step", "peba1_128_t2", 760, 8),
    ("cmux_step", "peba1_128_t2", 184, 8),
    ("cmux_step", "peba1_128_fast", 1000, 8),
    ("extprod_recombine", "peba1_128_t2", 8192, 1),
    ("extprod_recombine", "peba1_128_t2", 2048, 1),
    ("extprod_recombine", "peba1_128_t2", 1000, 1),
    ("extprod_recombine", "peba1_128_fast", 1000, 1),
    ("fused_blind_rotate", "peba1_128_fast_fused", 8192, 8),
    ("fused_blind_rotate", "peba1_128_fast_fused", 1000, 8),
    ("fused_blind_rotate", "peba1_128_fast_fused", 760, 8),
    ("fused_blind_rotate", "peba1_128_fast_fused", 184, 8),
    ("fused_blind_rotate", "peba1_128_t2_fused", 8192, 8),
    ("fused_blind_rotate", "peba1_128_t2_fused", 760, 8),
    ("fused_blind_rotate", "peba1_128_t2_fused", 184, 8),
    ("fused_blind_rotate", "peba1_128_fast_fused_k256", 1000, 8),
)
STEP_KERNELS = ("cmux_step_gen", "blind_rotate_gen_full", "cmux_step", "fused_blind_rotate")
# kernel -> (source, TPU kernel it replaces)
KERNELS = {
    "cmux_step_gen": ("peba1_tpu_torch/csrc/cmux_step_gen.cu",
                      "peba1_tpu/ops/pallas_kernels.py:467"),
    "blind_rotate_gen_full": ("peba1_tpu_torch/csrc/blind_rotate_gen_full.cu",
                              "peba1_tpu/ops/pallas_kernels.py:607"),
    "rotate_decompose": ("peba1_tpu_torch/csrc/rotate_decompose.cu",
                         "peba1_tpu/ops/pallas_kernels.py:660"),
    "cmux_step": ("peba1_tpu_torch/csrc/cmux_step.cu",
                  "peba1_tpu/ops/pallas_kernels.py:342"),
    "extprod_recombine": ("peba1_tpu_torch/csrc/cmux_step.cu",
                          "peba1_tpu/ops/pallas_kernels.py:266"),
    "fused_blind_rotate": ("peba1_tpu_torch/csrc/fused_blind_rotate.cu",
                           "peba1_tpu/ops/pallas_kernels.py:168"),
}
# kernel -> the sources of its narrow step, which it takes at
# cuda_kernels.NARROW_MAX_ROWS rows or fewer
NARROW_SOURCES = {
    "cmux_step_gen": ("peba1_tpu_torch/csrc/cmux_step_gen_narrow.cu",
                      "peba1_tpu_torch/csrc/narrow_rotation.cuh"),
    "blind_rotate_gen_full": ("peba1_tpu_torch/csrc/blind_rotate_gen_full_narrow.cu",
                              "peba1_tpu_torch/csrc/narrow_rotation.cuh"),
}
# A kernel with no single PyTorch call that computes what it computes.
NO_LIBRARY_CALL = {"rotate_decompose": "none: no single PyTorch call computes "
                                       "rotate + decompose"}
COPY_NOTE = ("a device-to-device Tensor.copy_ moving as many bytes, on the card alone: "
             "a ceiling the kernel can reach, never called by the port")


def fused_params() -> dict:
    """The use_fused_cmux configurations (no preset sets it; the JAX
    package's scripts/diag.py:55-69 builds them the same way): label ->
    TfheParams.  K = amat_block = 128 (U = 8) unless the label says k256."""
    from peba1_tpu_torch.params import PEBA1_128_FAST, PEBA1_128_T2
    fast = dataclasses.replace(PEBA1_128_FAST, use_fused_cmux=True)
    return {"peba1_128_fast_fused": fast,
            "peba1_128_fast_fused_k256": dataclasses.replace(fast, amat_block=256),
            "peba1_128_t2_fused": dataclasses.replace(
                PEBA1_128_T2, use_fused_step=False, use_pallas_rotate=False,
                use_fused_cmux=True)}


def cell_params() -> dict:
    """The lattices of the benchmark's cells that no preset holds: label ->
    TfheParams.  peba1_tfhe128_genf is TFHE v1.x's lambda=128 set (l=3,
    Bgbit=7, the key exact) on kernel 2, as perfbench/configs/peba1_tfhe128.json
    runs it."""
    from peba1_tpu_torch.params import PEBA1_128
    return {"peba1_tfhe128_genf": dataclasses.replace(
        PEBA1_128, use_pallas_rotate=True, use_gen_step=True, use_gen_full=True)}


def params_of(name: str):
    from peba1_tpu_torch.params import PRESETS
    if name in PRESETS:
        return PRESETS[name]
    return {**fused_params(), **cell_params()}[name]


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def torch_is_cuda(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, timed with CUDA events."""
    import torch
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float | None:
    """Mean milliseconds of fn() on the card alone: the calls are enqueued
    while the card sleeps, so the host's work between launches is not timed
    (`event_ms` times both, and a small kernel's call waits on the host).
    None where this torch has no device sleep."""
    import torch
    if not hasattr(torch.cuda, "_sleep"):
        return None
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # about 0.1 s, far longer than enqueuing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def free_device_memory() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reset_peak(device) -> None:
    import torch
    if torch_is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device) -> float:
    import torch
    return torch.cuda.max_memory_allocated(device) / 1e9 if torch_is_cuda(device) else 0.0


def phase_device() -> dict:
    import torch
    smi = card_label(torch.device("cuda", 0))
    print(smi, flush=True)
    return {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from peba1_tpu_torch.ops import cuda_kernels as ck
    t0 = time.time()
    libs = ck.build()
    info = {}
    for stem, lib in libs.items():
        ptxas = lib.parent / f"{stem}.ptxas.txt"
        info[stem] = [ln.strip() for ln in ptxas.read_text().splitlines()
                      if "registers" in ln or "spill" in ln] if ptxas.exists() else []
        spills = [ln for ln in info[stem] if "spill" in ln and
                  not ln.endswith("0 bytes spill stores, 0 bytes spill loads")]
        check(not spills, f"{stem}: ptxas reports register spills: {spills}")
    return {"phase": "build", "seconds": time.time() - t0, "ptxas": info}


def _inputs(kernel: str, p, B: int, steps: int, device, seed: int):
    """Seeded random inputs of `kernel` at p's shapes: (args, index of the
    argument it updates in place or None, int8 MACs, bytes it must move,
    the (B, G*N) x (G*N, C*N) GEMM of one step or None)."""
    import torch
    rng = np.random.default_rng(seed)
    k1, G, C = p.k + 1, (p.k + 1) * p.l, sum(p.limb_plan)
    GN, CN = G * p.N, C * p.N

    def i32(shape):
        return torch.as_tensor(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                               .astype(np.int32), device=device)

    def i8(shape, lo=-128, hi=128):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int8), device=device)

    def rot(shape):
        return torch.as_tensor(rng.integers(0, 2 * p.N, shape, dtype=np.int32), device=device)

    acc_bytes = B * k1 * p.N * 4
    macs = steps * B * GN * CN
    if kernel == "cmux_step_gen":
        args = (i32((B, k1 * p.N)), rot((steps, B)), i8((steps, G, C, 2 * p.N)), p)
        nbytes = 2 * acc_bytes + args[1].nbytes + args[2].nbytes
        return args, 0, macs, nbytes, (i8((B, GN)), i8((CN, GN)))
    if kernel == "blind_rotate_gen_full":
        args = (rot((steps + 1, B)), i8((steps, G, C, 2 * p.N)), MU, p)
        return (args, None, macs, args[0].nbytes + args[1].nbytes + acc_bytes,
                (i8((B, GN)), i8((CN, GN))))
    if kernel == "fused_blind_rotate":
        from peba1_tpu_torch.ops.poly import amat_geometry
        K, _, span = amat_geometry(p.N, p.amat_block)
        args = (rot((steps + 1, B)), i8((steps, C, G, span, K)), MU, p)
        return (args, None, macs, args[0].nbytes + args[1].nbytes + acc_bytes,
                (i8((B, GN)), i8((CN, GN))))
    if kernel == "rotate_decompose":
        amt = rot((B,))
        amt[:3] = torch.tensor([0, p.N, 2 * p.N - 1][:B])    # no shift, negation, the last
        args = (i32((B, k1 * p.N)), amt, p)
        return args, None, 0, acc_bytes + args[1].nbytes + B * GN, None
    if kernel == "cmux_step":
        args = (i32((B, k1 * p.N)), rot((steps, B)), i8((steps, CN, GN)), p)
        nbytes = 2 * acc_bytes + args[1].nbytes + args[2].nbytes
        return args, 0, macs, nbytes, (i8((B, GN)), args[2][0])
    if kernel == "extprod_recombine":
        args = (i8((B, GN), -p.half_bg, p.half_bg), i8((CN, GN)), p)
        return (args, None, macs, args[0].nbytes + args[1].nbytes + acc_bytes,
                (args[0], args[1]))
    raise ValueError(kernel)


def kernel_case(kernel: str, params_name: str, B: int, steps: int, device,
                timed: bool, seed: int = 0) -> dict:
    """`kernel` against its plain twin on seeded random inputs; with `timed`,
    CUDA-event times of the kernel (with the host's work between calls, and
    on the card alone), the twin and torch._int_mm on the GEMM of one step,
    and the bound of the same work.  Step kernels report per CMUX step.
    rotate_decompose also reports `copy_ms`, one device-to-device
    Tensor.copy_ of half its bytes (so it reads and writes as many bytes as
    the kernel), on the card alone: a yardstick the port never calls."""
    import torch
    from peba1_tpu_torch.ops import cuda_kernels as ck
    p = params_of(params_name)
    args, inplace, macs, nbytes, gemm = _inputs(kernel, p, B, steps, device, seed)
    wrapper, plain = getattr(ck, kernel), getattr(ck, kernel + "_plain")

    def call(fn, a=args):
        a = list(a)
        if inplace is not None:
            a[inplace] = a[inplace].clone()
        return fn(*a)

    want = call(plain)
    launched, narrow = ck.launches[kernel], ck.narrow_calls.get(kernel, 0)
    got = call(wrapper)
    sync(device)
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    per = steps if kernel in STEP_KERNELS else 1
    out = {"kernel": kernel, "params": params_name, "B": B, "steps": steps,
           "unit": "ms per CMUX step" if kernel in STEP_KERNELS else "ms per call",
           "mismatches": int((got != want).sum()), "max_abs_err": int(diff.max()),
           "launches": ck.launches[kernel] - launched,
           "narrow_calls": ck.narrow_calls.get(kernel, 0) - narrow}
    if timed:
        bufs = list(args)
        if inplace is not None:
            bufs[inplace] = bufs[inplace].clone()
        out["ms"] = event_ms(lambda: wrapper(*bufs), 3) / per
        dev_ms = device_ms(lambda: wrapper(*bufs), 10)
        out["device_ms"] = None if dev_ms is None else dev_ms / per
        out["plain_ms"] = event_ms(lambda: plain(*bufs), 2) / per
        t_ops, t_bytes = 2 * macs / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        out["bound_ms"] = max(t_ops, t_bytes) * 1e3 / per
        out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        out["library_ms"] = None
        if kernel == "rotate_decompose":
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            out["copy_ms"] = device_ms(lambda: dst.copy_(src), 10)
        if gemm is not None:   # the GEMM alone, one step: torch._int_mm
            a, wt = gemm
            try:
                out["library_ms"] = event_ms(lambda: torch._int_mm(a, wt.T), 3)
            except RuntimeError as e:        # a yardstick only; the port never calls it
                out["library_error"] = str(e).splitlines()[0][:200]
    return out


def phase_kernel(device, cases=KERNEL_CASES) -> dict:
    out = [kernel_case(kernel, name, B, steps, device, timed=torch_is_cuda(device))
           for kernel, name, B, steps in cases]
    from peba1_tpu_torch.ops import cuda_kernels as ck
    for c in out:
        check(c["mismatches"] == 0, f"{c['kernel']} disagrees with its plain twin: {c}")
        if torch_is_cuda(device):
            narrow = c["kernel"] in ck.BY_STAGE and ck.narrow_step(c["B"])
            check(c["launches"] == 1 and c["narrow_calls"] == narrow,
                  f"{c['kernel']} at {c['B']} rows: {c['launches']} launches, "
                  f"{c['narrow_calls']} narrow calls, want 1 and {int(narrow)}")
    return {"phase": "kernel", "cases": out}


def expected_launches(p, calls: int) -> dict:
    """The CUDA launches `calls` bootstrap calls at p make, by kernel."""
    from peba1_tpu_torch.ops import cuda_kernels
    from peba1_tpu_torch.ops.bootstrap import selected_kernel
    want = dict.fromkeys(cuda_kernels.launches, 0)
    kernel = selected_kernel(p)
    if kernel == "cmux_step" and p.w_streaming:
        want[kernel] = p.n * calls           # one call a step, W built per step
    elif kernel is not None:
        want[kernel] = calls                 # one launch a rotation
    else:
        want["rotate_decompose"] = p.n * calls if p.use_pallas_rotate else 0
        want["extprod_recombine"] = p.n * calls if p.use_pallas_extprod else 0
    return want


def phase_gate(params, B: int, steps: int, device, seed: int = 0, label: str = "",
               keyset=None):
    """Keygen at `params` (a preset name or TfheParams), or the given
    (secret key, cloud key) pair, a warm-up bootstrap, then a chain of
    `steps` bootstraps of B bits, decrypted and counted."""
    import torch
    from peba1_tpu_torch import gates, keys
    from peba1_tpu_torch.bench import chain
    from peba1_tpu_torch.ops import cuda_kernels
    p = params_of(params) if isinstance(params, str) else params
    label = label or params
    reset_peak(device)
    t0 = time.time()
    sk, ck = keyset or keys.keygen(torch.Generator(device=device).manual_seed(seed), p,
                                   device)
    sync(device)
    t_keygen = 0.0 if keyset else time.time() - t0
    bits = np.random.default_rng(seed).integers(0, 2, B)
    g_enc = torch.Generator(device=device).manual_seed(seed + 1)
    chain(ck, gates.encrypt_bits(g_enc, sk, bits), 1)          # warm-up
    ct = gates.encrypt_bits(g_enc, sk, bits)
    sync(device)
    cuda_kernels.reset_launches()
    t0 = time.time()
    out = chain(ck, ct, steps)
    sync(device)
    dt = time.time() - t0
    launches, narrow = dict(cuda_kernels.launches), dict(cuda_kernels.narrow_calls)
    got = gates.decrypt_bits(out, sk).cpu().numpy()
    frac = float((got == bits).mean())
    check(frac == 1.0, f"{label}: gate chain decrypts {frac} correct, want 1.0")
    if torch_is_cuda(device):
        check(launches == expected_launches(p, steps),
              f"{label}: launches {launches}, want {expected_launches(p, steps)}")
        check(B <= cuda_kernels.NARROW_MAX_ROWS or not any(narrow.values()),
              f"{label}: {narrow} narrow calls at {B} rows")
    key_gb = sum(t.nbytes for t in (ck.bk_tp, ck.bk_w, ck.bk_amat, ck.bk_conv,
                                     ck.ks_table_limbs, ck.bk) if t is not None) / 1e9
    return (sk, ck), {"phase": "gate", "params": label, "B": B,
                      "chain": steps, "keygen_seconds": t_keygen,
                      "seconds": dt, "bootstraps_per_s": steps * B / dt,
                      "batch_correct_frac": frac, "launches": launches,
                      "narrow_calls": narrow, "key_gb": key_gb, "peak_gb": peak_gb(device)}


def phase_rotation_equal(keyset, B: int, device, label: str, seed: int = 0) -> dict:
    """The keyset's kernel path (use_gen_full, use_fused_cmux or cmux_step on
    bk_w) against the use_gen_step rotation (cmux_step_gen) on the same key
    and ciphertexts, at the full n: bit-equal accumulators."""
    import torch
    from peba1_tpu_torch import gates, lwe
    from peba1_tpu_torch.ops import bootstrap as bs
    from peba1_tpu_torch.ops import rotate
    sk, ck = keyset
    p = ck.params
    bits = np.random.default_rng(seed + 5).integers(0, 2, B)
    ct = gates.encrypt_bits(torch.Generator(device=device).manual_seed(seed + 6), sk, bits)
    pre = lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8)
    bara, barb = rotate.modswitch_2n(pre.a, p.N), rotate.modswitch_2n(pre.b, p.N)
    full = bs.blind_rotate(ck, bara, barb, gates.MU_1_8)
    step_p = dataclasses.replace(p, use_fused_cmux=False, use_gen_full=False,
                                 use_gen_step=True)
    step = bs.blind_rotate(dataclasses.replace(ck, params=step_p), bara, barb, gates.MU_1_8)
    sync(device)
    mismatches = int((full != step).sum())
    check(mismatches == 0, f"{label}: {bs.selected_kernel(p)} and cmux_step_gen "
          f"rotations differ in {mismatches} places")
    return {"phase": "rotation_equal", "params": f"{label} vs use_gen_step",
            "kernel": bs.selected_kernel(p), "B": B, "steps": p.n,
            "mismatches": mismatches}


def phase_step_equal(keyset, B: int, device, label: str, seed: int = 0) -> dict:
    """The keyset's step kernel (cmux_step_gen on bk_tp, or cmux_step on
    bk_w) over its n steps (one launch) against its plain twin, on the key
    and ciphertexts of a bootstrap call: bit-equal accumulators.  The
    kernels share their device code, so this holds each against a second,
    independent code; phase_rotation_equal does not."""
    import torch
    from peba1_tpu_torch import gates
    from peba1_tpu_torch.ops import cuda_kernels, rotate
    from peba1_tpu_torch.ops.bootstrap import selected_kernel
    sk, ck = keyset
    p = ck.params
    kernel = selected_kernel(p)
    key = ck.bk_tp if kernel == "cmux_step_gen" else ck.bk_w
    bits = np.random.default_rng(seed + 7).integers(0, 2, B)
    ct = gates.encrypt_bits(torch.Generator(device=device).manual_seed(seed + 8), sk, bits)
    bara = rotate.modswitch_2n(ct.a * 2, p.N)
    barb = rotate.modswitch_2n(ct.b * 2 - gates.MU_1_8, p.N)
    acc = rotate.initial_accumulator((2 * p.N - barb) % (2 * p.N), gates.MU_1_8, p)
    amt = bara.T.contiguous()
    t0 = time.time()
    want = getattr(cuda_kernels, kernel + "_plain")(acc.clone(), amt, key, p)
    sync(device)
    t_plain = time.time() - t0
    before = cuda_kernels.launches[kernel]
    t0 = time.time()
    got = getattr(cuda_kernels, kernel)(acc.clone(), amt, key, p)
    sync(device)
    dt = time.time() - t0
    launches = cuda_kernels.launches[kernel] - before
    mismatches = int((got != want).sum())
    check(mismatches == 0, f"{label}: {kernel} and its plain twin differ in "
          f"{mismatches} places over {p.n} steps")
    if torch_is_cuda(device):
        check(launches == 1, f"{label}: {kernel} launched {launches} times, want 1")
    return {"phase": "step_equal", "params": label, "kernel": kernel, "B": B,
            "steps": p.n, "mismatches": mismatches, "launches": launches,
            "seconds": dt, "plain_seconds": t_plain}


def phase_auth(keyset, nslots: int, bitsize: int, device, label: str,
               seed: int = 0) -> dict:
    import torch
    from peba1_tpu_torch import clear
    from peba1_tpu_torch import circuits as cc
    from peba1_tpu_torch.backends import CountingBackend
    from peba1_tpu_torch.ops import cuda_kernels
    from peba1_tpu_torch.params import ProtocolParams
    from peba1_tpu_torch.protocol import ClientDevice, Server
    from peba1_tpu_torch.utils.bits import int_to_bits
    sk, ck = keyset
    reset_peak(device)
    bound = 2 * nslots
    proto = ProtocolParams(nslots=nslots, bitsize=bitsize, max_bitsize=3 * bitsize,
                           mul_width=3 * bitsize - 1, bound_match=bound)
    rng = np.random.default_rng(seed)
    hi = (1 << bitsize) - 1
    template = rng.integers(1, hi, (2, nslots))
    genuine = template[0] + 1                                # ED = nslots
    impostor = rng.integers(1, hi + 1, nslots)
    while clear.euclidean_distance(template[1], impostor) <= bound:
        impostor = rng.integers(1, hi + 1, nslots)
    probe = np.stack([genuine, impostor])
    ed = [int(clear.euclidean_distance(template[i], probe[i])) for i in range(2)]
    want_b = np.array([int(e > bound) for e in ed])
    check(list(want_b) == [0, 1], f"test vectors: ED {ed} vs bound {bound}")

    # The bootstraps the cipher circuit runs, counted on plaintext bits.
    counter = CountingBackend()
    f_bits = cc.function_f(counter, int_to_bits(probe, bitsize, "cpu"),
                           int_to_bits(template, bitsize, "cpu"),
                           int_to_bits([bound, bound], 3 * bitsize, "cpu"), bitsize)
    cc.function_g(counter, f_bits, int_to_bits([0, 0], bitsize, "cpu"),
                  int_to_bits([0, 0], bitsize, "cpu"), bitsize)

    client = ClientDevice(7, sk, ck, proto)
    server = Server(ck, proto)
    g_enc = torch.Generator(device=device).manual_seed(seed + 2)
    g_auth = torch.Generator(device=device).manual_seed(seed + 3)
    enc_t = client.encrypt_vector(g_enc, template)
    enc_p = client.encrypt_vector(g_enc, probe)
    enc_bound = client.encrypt_word(g_enc, [bound, bound], 3 * bitsize)
    sync(device)
    cuda_kernels.reset_launches()
    t0 = time.time()
    res = server.authenticate(g_auth, enc_p, enc_t, enc_bound)
    sync(device)
    dt = time.time() - t0
    launches, narrow = dict(cuda_kernels.launches), dict(cuda_kernels.narrow_calls)
    b = client.decrypt_word(res.enc_b)
    y = client.prove(res.enc_y)
    want_y = np.where(want_b == 1, res.r1, (-res.r0) % (1 << bitsize))
    verdict = server.verify_proof(res, y)
    p = ck.params
    out = {"phase": "auth", "params": label, "nslots": nslots, "bitsize": bitsize, "bound": bound,
           "requests": 2, "ed": ed, "b": b.tolist(), "want_b": want_b.tolist(),
           "y": y.tolist(), "want_y": want_y.tolist(),
           "is_match": verdict["is_match"].tolist(), "seconds": dt,
           "bootstraps": counter.bootstraps,
           "bootstrap_launches": server.be.launches, "launches": launches,
           "narrow_calls": narrow, "peak_gb": peak_gb(device)}
    check(np.array_equal(b, want_b), f"decisions {b.tolist()} != {want_b.tolist()}")
    check(np.array_equal(y, want_y), f"y {y.tolist()} != {want_y.tolist()}")
    if torch_is_cuda(device):
        want = expected_launches(p, server.be.launches)
        check(launches == want and server.be.launches > 0,
              f"the authentication launched {launches}, want {want}")
    return out


def phase_sweep(keyset, nslots: int, bitsize: int, n_templates: int, chunk: int,
                device, label: str, seed: int = 0) -> dict:
    """A checkpointed 1:N identification sweep at full width: the client
    encrypts a probe, the template database (one near match, as
    scripts/sweep_identify.make_inputs builds it, the others random) and the
    bound; each crosses to the server as an io/wire frame; IdentifySweep
    runs Server.identify chunk by chunk into a checkpoint directory.  Then
    the same sweep again on the same directory: it must skip every chunk
    with 0 launches, and collect() must return the same tensors."""
    import io
    import shutil
    import torch
    from peba1_tpu_torch import circuits as cc
    from peba1_tpu_torch.backends import CountingBackend
    from peba1_tpu_torch.io import wire
    from peba1_tpu_torch.ops import cuda_kernels
    from peba1_tpu_torch.params import ProtocolParams
    from peba1_tpu_torch.protocol import ClientDevice, Server
    from peba1_tpu_torch.sweep import IdentifySweep
    from peba1_tpu_torch.utils.bits import int_to_bits
    from peba1_tpu_torch.utils.logging import EventLog
    sk, ck = keyset
    p = ck.params
    bound = 2 * nslots
    proto = ProtocolParams(nslots=nslots, bitsize=bitsize, max_bitsize=3 * bitsize,
                           mul_width=3 * bitsize - 1, bound_match=bound)
    rng = np.random.default_rng(seed)
    hi = (1 << bitsize) - 1
    templates = rng.integers(1, hi + 1, (n_templates, nslots))
    probe = np.minimum(templates[n_templates // 3] + 1, hi)
    dist = ((templates - probe) ** 2).sum(1)
    want = (dist > bound).astype(int)
    check(int(want.sum()) == n_templates - 1, f"test vectors: distances {dist.tolist()}")

    # The bootstraps Server.identify's circuit runs, counted on plaintext.
    counter = CountingBackend()
    cc.function_f(counter, int_to_bits(np.broadcast_to(probe, templates.shape), bitsize, "cpu"),
                  int_to_bits(templates, bitsize, "cpu"),
                  int_to_bits([bound] * n_templates, 3 * bitsize, "cpu"), bitsize)

    client = ClientDevice(7, sk, ck, proto)
    g_enc = torch.Generator(device=device).manual_seed(seed + 4)
    frames = {"probe": wire.encode_ciphertext(client.encrypt_vector(g_enc, probe)),
              "templates": wire.encode_ciphertext(client.encrypt_vector(g_enc, templates)),
              "bound": wire.encode_ciphertext(client.encrypt_word(g_enc, bound, 3 * bitsize))}
    server = Server(ck, proto)
    probe_ct, templates_ct, bound_ct = (wire.decode_ciphertext(frames[k], device)[0]
                                        for k in ("probe", "templates", "bound"))
    out_dir = os.path.join(ROOT, "build", "smoke_sweep")
    shutil.rmtree(out_dir, ignore_errors=True)
    events = io.StringIO()
    sweep = IdentifySweep(server, out_dir, chunk=chunk, log=EventLog(stream=events))
    reset_peak(device)
    sync(device)
    cuda_kernels.reset_launches()
    t0 = time.time()
    plan = sweep.run(probe_ct, templates_ct, bound_ct)
    sync(device)
    dt = time.time() - t0
    launches = dict(cuda_kernels.launches)
    calls = server.be.launches
    first = sweep.collect(device)
    got = client.decrypt_word(first)

    cuda_kernels.reset_launches()
    t0 = time.time()
    sweep.run(probe_ct, templates_ct, bound_ct)
    dt_resume = time.time() - t0
    resumed_launches = dict(cuda_kernels.launches)
    again = sweep.collect(device)
    log = [json.loads(line) for line in events.getvalue().splitlines()]
    shutil.rmtree(out_dir, ignore_errors=True)

    out = {"phase": "sweep", "params": label, "nslots": nslots, "bitsize": bitsize,
           "bound": bound, "n_templates": n_templates, "chunk": chunk,
           "n_chunks": plan.n_chunks, "fingerprint": plan.fingerprint,
           "distances": dist.tolist(), "b": got.tolist(), "want_b": want.tolist(),
           "wire_native": wire.have_native(),
           "wire_bytes": {k: len(v) for k, v in frames.items()},
           "seconds": dt, "chunk_seconds": [e["seconds"] for e in log
                                            if e["event"] == "sweep_chunk"],
           "templates_per_s": n_templates / dt,
           "bootstraps_per_template": counter.bootstraps / n_templates,
           "bootstraps_per_s": counter.bootstraps / dt,
           "bootstrap_calls": calls, "launches": launches,
           "resume_seconds": dt_resume, "resume_launches": resumed_launches,
           "resume_bootstrap_calls": server.be.launches - calls,
           "peak_gb": peak_gb(device)}
    check(np.array_equal(got, want), f"sweep decisions {got.tolist()} != {want.tolist()}")
    check(torch.equal(first.a, again.a) and torch.equal(first.b, again.b),
          "the resumed sweep collects other tensors")
    check(not any(resumed_launches.values()) and server.be.launches == calls,
          f"the resumed sweep launched {resumed_launches}")
    if torch_is_cuda(device):
        want_l = expected_launches(p, calls)
        check(launches == want_l and calls > 0,
              f"the sweep launched {launches}, want {want_l}")
    return out


def tool_device(device) -> str:
    """The --device value of the port's tools for `device`."""
    import torch
    return torch.device(device).type


def _quiet(fn, *args, **kw):
    """fn(*args, **kw) with its progress lines (stdout) and events (stderr)
    kept out of the smoke's output; returns fn's result."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kw)


def phase_bench(keyset, device, label: str) -> dict:
    """The port's headline benchmark (python -m peba1_tpu_torch.bench) on the
    keyset, with short chains; its own JSON line is printed as it is."""
    from peba1_tpu_torch import bench
    from peba1_tpu_torch.ops import cuda_kernels
    s1, s2, reps = 1, 2, 1
    argv = ["--params", label, "--s1", str(s1), "--s2", str(s2), "--reps", str(reps),
            "--device", tool_device(device)]
    cuda_kernels.reset_launches()
    rec = bench.main(argv, keyset=keyset)
    launches = dict(cuda_kernels.launches)
    calls = (s1 + s2) * (1 + reps)               # a warm-up and `reps` runs a length
    check(rec["batch_correct_frac"] == 1.0, f"bench: fraction {rec['batch_correct_frac']}")
    if torch_is_cuda(device):
        want = expected_launches(keyset[1].params, calls)
        check(launches == want, f"bench launched {launches}, want {want}")
    return {"phase": "bench", "params": label, "value": rec["value"],
            "batch_correct_frac": rec["batch_correct_frac"], "launches": launches}


def phase_campaign(keyset, B: int, steps: int, device, label: str) -> dict:
    """The noise campaign (python -m peba1_tpu_torch.diag campaign) on the
    keyset: `steps` chained bootstraps of B bits, no chain error."""
    from peba1_tpu_torch import diag
    from peba1_tpu_torch.ops import cuda_kernels
    argv = ["campaign", "--params", label, "--batch", str(B), "--steps", str(steps),
            "--device", tool_device(device)]
    cuda_kernels.reset_launches()
    rec = _quiet(diag.main, argv, keyset=keyset)
    launches = dict(cuda_kernels.launches)
    check(rec["chain_error_frac"] == 0.0 and rec["final_decode_errs"] == 0,
          f"campaign: {rec}")
    if torch_is_cuda(device):
        want = expected_launches(keyset[1].params, steps)
        check(launches == want, f"campaign launched {launches}, want {want}")
    return {"phase": "campaign", **{k: rec[k] for k in (
        "params", "gates", "batch", "chain_steps", "chain_error_frac", "phase_sigma",
        "margin_sigmas", "seconds")}, "launches": launches}


def phase_sweep_cli(params: str, nslots: int, bitsize: int, n_templates: int,
                    device) -> dict:
    """The sweep CLI (python -m peba1_tpu_torch.sweep_identify), one template
    a chunk: a run stopped after one chunk, a resume to the end, then a
    finalize on the CPU, which must launch nothing."""
    import shutil
    from peba1_tpu_torch import sweep_identify
    from peba1_tpu_torch.ops import cuda_kernels
    from peba1_tpu_torch.ops.bootstrap import selected_kernel
    from peba1_tpu_torch.params import PRESETS
    out_dir = os.path.join(ROOT, "build", "smoke_sweep_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    base = ["--params", params, "--n-templates", str(n_templates), "--chunk", "1",
            "--nslots", str(nslots), "--bitsize", str(bitsize), "--dir", out_dir]
    on_card = base + ["--device", tool_device(device)]
    cuda_kernels.reset_launches()
    first = _quiet(sweep_identify.main, on_card + ["--max-chunks", "1"])
    resumed = _quiet(sweep_identify.main, on_card)
    launches = dict(cuda_kernels.launches)
    cuda_kernels.reset_launches()
    final = _quiet(sweep_identify.main, base + ["--finalize", "--device", "cpu"])
    final_launches = dict(cuda_kernels.launches)
    shutil.rmtree(out_dir, ignore_errors=True)
    check(first["status"] == "interrupted" and first["chunks_done"] == 1,
          f"sweep CLI, first run: {first}")
    check(resumed["status"] == "complete" and resumed["resumed_from_disk"] == 1
          and resumed["correct_frac"] == 1.0, f"sweep CLI, resume: {resumed}")
    check(final["status"] == "complete" and final["correct_frac"] == 1.0
          and final["decisions_verified"] == n_templates, f"sweep CLI, finalize: {final}")
    check(not any(final_launches.values()), f"the finalize launched {final_launches}")
    if torch_is_cuda(device):
        kernel = selected_kernel(PRESETS[params])
        check(launches[kernel] > 0, f"the sweep CLI launched {launches}")
    return {"phase": "sweep_cli", "params": params, "nslots": nslots, "bitsize": bitsize,
            "n_templates": n_templates, "chunk_seconds": {**first["chunk_seconds"],
                                                          **resumed["chunk_seconds"]},
            "templates_per_s_steady": resumed["templates_per_s_steady"],
            "correct_frac": resumed["correct_frac"],
            "fingerprint_match": final["fingerprint_match"], "launches": launches,
            "finalize_launches": final_launches}


def phase_matches(keyset, config: str, n_templates: int, nslots: int, bitsize: int,
                  device, label: str) -> dict:
    """The protocol benchmark (python -m peba1_tpu_torch.bench_matches) on
    the keyset: every decision right."""
    from peba1_tpu_torch import bench_matches
    from peba1_tpu_torch.ops import cuda_kernels
    argv = ["--config", config, "--params", label, "--n-templates", str(n_templates),
            "--nslots", str(nslots), "--bitsize", str(bitsize),
            "--device", tool_device(device)]
    cuda_kernels.reset_launches()
    rec = _quiet(bench_matches.main, argv, keyset=keyset)
    launches = dict(cuda_kernels.launches)
    check(rec["correct_frac"] == 1.0, f"bench_matches {config}: {rec}")
    if torch_is_cuda(device):
        want = expected_launches(keyset[1].params, rec["launches"])
        check(launches == want and rec["launches"] > 0,
              f"bench_matches launched {launches}, want {want}")
    return {"phase": "matches", **{k: rec[k] for k in (
        "metric", "value", "seconds", "items", "launches", "nslots", "bitsize", "params",
        "correct_frac", "peak_memory_bytes")}, "kernel_launches": launches}


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them ("cpu" in
    a rehearsal on the CPU): stated beside every time a phase prints."""
    if not torch_is_cuda(device):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, device) -> float:
    """Milliseconds of one call of fn(): CUDA events on the card, the host's
    clock around a synchronized call on the CPU."""
    import torch
    if not torch_is_cuda(device):
        t0 = time.time()
        fn()
        return (time.time() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel(keyset, B: int, rows: int, nslots: int, bitsize: int, device,
                   label: str, seed: int = 0) -> dict:
    """The parallel layer (peba1_tpu_torch.parallel) in a world of one rank
    on the card's own backend (NCCL; gloo in a rehearsal on the CPU), mesh
    1x1: sharded_bootstrap at B rows bit-equal to ops/bootstrap.bootstrap
    and launching the preset's kernel, both timed in turns (plain, sharded,
    sharded, plain); sharded_bootstrap_ringtp with overlap_blocks 1 and 2
    at `rows` over the full n, bit-equal and launching no kernel, with the
    share of its time that n column products (extprod_toeplitz_cols_i8 at
    the same shapes, timed alone) take; sharded_identify at full width on
    two templates, one a near match, decided right."""
    import torch
    import torch.distributed as dist
    from peba1_tpu_torch import gates
    from peba1_tpu_torch.ops import bootstrap as bs
    from peba1_tpu_torch.ops import cuda_kernels, poly
    from peba1_tpu_torch.parallel import mesh as pmesh
    from peba1_tpu_torch.parallel import shard as pshard
    from peba1_tpu_torch.params import ProtocolParams
    from peba1_tpu_torch.protocol import ClientDevice
    sk, ck = keyset
    p = ck.params
    kernel = bs.selected_kernel(p)
    rng = np.random.default_rng(seed + 9)
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    rank_device = pmesh.init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                                         device=device)
    try:
        backend = dist.get_backend()
        check(backend == ("nccl" if torch_is_cuda(device) else "gloo"),
              f"parallel: backend {backend} on {device}")
        mesh = pmesh.make_mesh(1, 1, device=rank_device)

        bits = rng.integers(0, 2, B)
        ct = gates.encrypt_bits(gen, sk, bits)
        want = bs.bootstrap(ck, ct, gates.MU_1_8)
        cuda_kernels.reset_launches()
        got = pshard.sharded_bootstrap(mesh, ck, ct, gates.MU_1_8)
        sync(device)
        launches = dict(cuda_kernels.launches)
        boot_mismatches = int((got.a != want.a).sum() + (got.b != want.b).sum())
        check(boot_mismatches == 0, f"parallel: sharded_bootstrap differs in {boot_mismatches}")
        check(bool((gates.decrypt_bits(got, sk).cpu().numpy() == bits).all()),
              "parallel: sharded_bootstrap decrypts wrong")
        if torch_is_cuda(device):
            check(kernel is not None and launches[kernel] > 0,
                  f"parallel: sharded_bootstrap launched {launches}")
        turns = [timed_ms(lambda: bs.bootstrap(ck, ct, gates.MU_1_8), device),
                 timed_ms(lambda: pshard.sharded_bootstrap(mesh, ck, ct, gates.MU_1_8), device),
                 timed_ms(lambda: pshard.sharded_bootstrap(mesh, ck, ct, gates.MU_1_8), device),
                 timed_ms(lambda: bs.bootstrap(ck, ct, gates.MU_1_8), device)]
        boot = {"B": B, "mismatches": boot_mismatches, "launches": launches,
                "ms_turns": turns, "plain_ms": (turns[0] + turns[3]) / 2,
                "sharded_ms": (turns[1] + turns[2]) / 2,
                "ratio": (turns[1] + turns[2]) / (turns[0] + turns[3])}

        bits = rng.integers(0, 2, rows)
        ct = gates.encrypt_bits(gen, sk, bits)
        want = bs.bootstrap(ck, ct, gates.MU_1_8)
        ring = []
        for K in (1, 2):
            cuda_kernels.reset_launches()
            got = None

            def run():
                nonlocal got
                got = pshard.sharded_bootstrap_ringtp(mesh, ck, ct, gates.MU_1_8,
                                                      overlap_blocks=K)
            ms = timed_ms(run, device)
            mism = int((got.a != want.a).sum() + (got.b != want.b).sum())
            check(mism == 0, f"parallel: ring-TP with overlap_blocks={K} differs in {mism}")
            check(not any(cuda_kernels.launches.values()),
                  f"parallel: ring-TP launched {cuda_kernels.launches}")
            ring.append({"overlap_blocks": K, "rows": rows, "steps": p.n,
                         "mismatches": mism, "ms": ms})
        G = (p.k + 1) * p.l
        d = torch.as_tensor(rng.integers(-p.half_bg, p.half_bg, (rows, G, p.N)).astype(np.int8),
                            device=device)

        def products():
            for s in range(p.n):
                poly.extprod_toeplitz_cols_i8(d, ck.bk_tp[s], p.limb_plan, 0, p.N)
        product_ms = timed_ms(products, device)

        bound = 2 * nslots
        proto = ProtocolParams(nslots=nslots, bitsize=bitsize, max_bitsize=3 * bitsize,
                               mul_width=3 * bitsize - 1, bound_match=bound)
        hi = (1 << bitsize) - 1
        templates = rng.integers(1, hi + 1, (2, nslots))
        probe = np.minimum(templates[0] + 1, hi)
        dist_clear = ((templates - probe) ** 2).sum(1)
        want_b = (dist_clear > bound).astype(int)
        check(want_b.tolist() == [0, 1], f"test vectors: distances {dist_clear.tolist()}")
        client = ClientDevice(7, sk, ck, proto)
        t_ct = client.encrypt_vector(gen, templates)
        p_ct = client.encrypt_vector(gen, probe)
        bound_ct = client.encrypt_word(gen, bound, 3 * bitsize)
        sync(device)
        cuda_kernels.reset_launches()
        t0 = time.time()
        out = pshard.sharded_identify(mesh, ck, p_ct, t_ct, bound_ct, bitsize)
        sync(device)
        ident_s = time.time() - t0
        ident_launches = dict(cuda_kernels.launches)
        b = client.decrypt_word(out)
        check(np.array_equal(b, want_b), f"parallel: identify decisions {b.tolist()}")
        if torch_is_cuda(device):
            check(ident_launches[kernel] > 0,
                  f"parallel: sharded_identify launched {ident_launches}")
    finally:
        dist.destroy_process_group()
    return {"phase": "parallel", "params": label, "card": card_label(device),
            "world": 1, "backend": backend, "mesh": [1, 1], "bootstrap": boot,
            "ringtp": ring, "ringtp_product_ms": product_ms,
            "ringtp_product_share": product_ms / ring[0]["ms"],
            "identify": {"nslots": nslots, "bitsize": bitsize, "n_templates": 2,
                         "distances": dist_clear.tolist(), "b": b.tolist(),
                         "want_b": want_b.tolist(), "seconds": ident_s,
                         "launches": ident_launches}}


def phase_dryrun(world: int, params: str, device) -> dict:
    """The multi-rank dry run (python -m peba1_tpu_torch.dryrun) in process:
    `world` ranks sharing the card over gloo (gloo CPU ranks in a rehearsal
    on the CPU), every check of JAX's dry run passing, and on the card
    every rank launching the preset's kernel, if it has one, wherever a
    bootstrap runs through it."""
    from peba1_tpu_torch import dryrun
    from peba1_tpu_torch.ops.bootstrap import selected_kernel
    from peba1_tpu_torch.params import PRESETS
    argv = ["--world", str(world), "--params", params]
    argv += ["--share-card"] if torch_is_cuda(device) else ["--device", "cpu"]
    rec = _quiet(dryrun.main, argv)
    checks = ["sharded_bootstrap", "ringtp_k1", "ringtp_k2", "gspmd_identify",
              "gspmd_identify_argmin"]
    check(rec["checks"] == checks and len(rec["launches"]) == world,
          f"dryrun world {world}: {rec}")
    kernel = selected_kernel(PRESETS[params])
    if torch_is_cuda(device) and kernel is not None:
        for name in ("sharded_bootstrap", "gspmd_identify", "gspmd_identify_argmin"):
            per_rank = [r[name].get(kernel, 0) for r in rec["launches"]]
            check(min(per_rank) > 0, f"dryrun world {world}: {name} launched {kernel} "
                                     f"{per_rank} times on its ranks")
    return {"phase": "dryrun", "card": card_label(device), **rec}


def phase_ntt(device, sizes=(1024, 2048), seed=0) -> dict:
    """The exact NTT (ops/ntt.py, plain torch on the card) at the ring
    sizes: the product equal to ops/poly.negacyclic_mul_naive on int8-range
    operands, and intt(ntt(x)) == x."""
    import torch
    from peba1_tpu_torch.ops import ntt, poly
    rng = np.random.default_rng(seed + 11)
    cases = []
    for N in sizes:
        a, b = (torch.as_tensor(rng.integers(-128, 128, (4, N)).astype(np.int32), device=device)
                for _ in range(2))
        x = torch.as_tensor(rng.integers(-(1 << 20), 1 << 20, (4, N)).astype(np.int32),
                            device=device)
        got = ntt.negacyclic_mul_exact(a, b)
        want = poly.negacyclic_mul_naive(a, b)
        back = ntt.intt_negacyclic(ntt.ntt_negacyclic(x))
        sync(device)
        case = {"N": N, "rows": 4, "mismatches": int((got != want).sum()),
                "roundtrip_mismatches": int((back != x).sum()),
                "ms": timed_ms(lambda: ntt.negacyclic_mul_exact(a, b), device),
                "naive_ms": timed_ms(lambda: poly.negacyclic_mul_naive(a, b), device)}
        check(case["mismatches"] == 0 and case["roundtrip_mismatches"] == 0,
              f"ntt: {case}")
        cases.append(case)
    return {"phase": "ntt", "card": card_label(device), "cases": cases}


def kernels_line(kernel: dict, main: dict) -> dict:
    """One entry per kernel: its first (largest) case's numbers, the largest
    error over all its cases, and its launches on its main path (and on the
    other paths that were read for it); for kernels 1 and 2 also the sources
    of their narrow step and its cases."""
    rows = []
    for name, (source, replaces) in KERNELS.items():
        cases = [c for c in kernel["cases"] if c["kernel"] == name]
        first = cases[0]
        first_path, *others = main[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": first_path["launches"],
                     "launches_from": first_path["from"],
                     **({"other_paths": others} if others else {}),
                     "max_abs_err": max(c["max_abs_err"] for c in cases),
                     "ms": first["ms"], "device_ms": first["device_ms"],
                     "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"],
                     **({"library_note": NO_LIBRARY_CALL[name]}
                        if name in NO_LIBRARY_CALL else {}),
                     **({"copy_ms": first["copy_ms"], "copy_note": COPY_NOTE}
                        if "copy_ms" in first else {}),
                     **({"narrow_sources": list(NARROW_SOURCES[name]),
                         "narrow_cases": [{k: c[k] for k in ("params", "B", "device_ms",
                                                             "max_abs_err")}
                                          for c in cases if c["narrow_calls"]]}
                        if name in NARROW_SOURCES else {}),
                     "case": {k: first[k] for k in ("params", "B", "steps", "unit")}})
    return {"kernels": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from peba1_tpu_torch.ops import cuda_kernels  # noqa: F401
        from peba1_tpu_torch.params import PEBA1_128_T2
    except ImportError as e:
        print(f"chip_smoke: the peba1_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    t_start = time.time()
    main_path = {}      # kernel -> [{"from": phase that read its launches, "launches": n}]

    def path(label, launches, *kernels, **extra):
        for k in kernels:
            main_path.setdefault(k, []).append({"from": label, "launches": launches[k],
                                                **extra})

    try:
        emit(phase_device())
        emit(phase_build())
        kernel = phase_kernel(device)
        emit(kernel)
        emit(phase_ntt(device))

        keyset, gate = phase_gate("peba1_128_t2_gen", 8192, 3, device)
        emit(gate)
        emit(phase_step_equal(keyset, 184, device, "peba1_128_t2_gen"))
        auth = phase_auth(keyset, 128, 8, device, "peba1_128_t2_gen")
        emit(auth)
        path("auth peba1_128_t2_gen", auth["launches"], "cmux_step_gen")
        emit(phase_bench(keyset, device, "peba1_128_t2_gen"))
        emit(phase_matches(keyset, "argmin", 2, 128, 8, device, "peba1_128_t2_gen"))
        par = phase_parallel(keyset, 8192, 184, 128, 8, device, "peba1_128_t2_gen")
        emit(par)
        path("parallel sharded_bootstrap peba1_128_t2_gen", par["bootstrap"]["launches"],
             "cmux_step_gen")
        path("parallel sharded_identify peba1_128_t2_gen", par["identify"]["launches"],
             "cmux_step_gen")
        del keyset
        free_device_memory()

        emit(phase_dryrun(2, "toy", device))
        dry = phase_dryrun(4, "peba1_128_t2_gen", device)
        emit(dry)
        for name in ("sharded_bootstrap", "gspmd_identify"):
            per_rank = [r[name].get("cmux_step_gen", 0) for r in dry["launches"]]
            path(f"dryrun world 4 {name} peba1_128_t2_gen, all ranks",
                 {"cmux_step_gen": sum(per_rank)}, "cmux_step_gen", per_rank=per_rank)

        keyset, gate = phase_gate("peba1_128_fast_genf", 8192, 3, device)
        emit(gate)
        emit(phase_rotation_equal(keyset, 8192, device, "peba1_128_fast_genf"))
        auth = phase_auth(keyset, 128, 8, device, "peba1_128_fast_genf")
        emit(auth)
        path("auth peba1_128_fast_genf", auth["launches"], "blind_rotate_gen_full")
        emit(phase_campaign(keyset, 8192, 8, device, "peba1_128_fast_genf"))
        del keyset
        free_device_memory()

        keyset, gate = phase_gate("peba1_128_t2", 8192, 3, device)
        emit(gate)
        path("gate peba1_128_t2", gate["launches"], "cmux_step")
        emit(phase_step_equal(keyset, 184, device, "peba1_128_t2"))
        emit(phase_rotation_equal(keyset, 8192, device, "peba1_128_t2"))
        sk, ck = keyset
        stream = dataclasses.replace(ck.params, w_streaming=True)
        gate = phase_gate(stream, 8192, 2, device, label="peba1_128_t2 w_streaming",
                          keyset=(sk, dataclasses.replace(ck, params=stream)))[1]
        emit(gate)
        del keyset, sk, ck
        free_device_memory()

        keyset, gate = phase_gate("peba1_128_fast", 2048, 2, device)
        emit(gate)
        path("gate peba1_128_fast", gate["launches"], "rotate_decompose")
        del keyset
        free_device_memory()

        extprod = dataclasses.replace(PEBA1_128_T2, use_fused_step=False,
                                      use_pallas_extprod=True)
        keyset, gate = phase_gate(extprod, 2048, 1, device,
                                  label="peba1_128_t2 use_pallas_extprod")
        emit(gate)
        path("gate peba1_128_t2 use_pallas_extprod", gate["launches"], "extprod_recombine")
        del keyset
        free_device_memory()

        fused = "peba1_128_fast_fused"
        keyset, gate = phase_gate(fused, 8192, 3, device)
        emit(gate)
        emit(phase_rotation_equal(keyset, 8192, device, fused))
        sweep = phase_sweep(keyset, 128, 8, 4, 4, device, fused)
        emit(sweep)
        path(f"sweep {fused}", sweep["launches"], "fused_blind_rotate")
        del keyset
        free_device_memory()

        emit(phase_sweep_cli("peba1_128_t2_gen", 128, 8, 2, device))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "done", "seconds": time.time() - t_start})
    for name, paths in main_path.items():
        for entry in paths:
            if entry["launches"] <= 0:
                print(f"chip_smoke: FAILED: {name} launched {entry['launches']} times in "
                      f"{entry['from']}", file=sys.stderr)
                return 1
    emit(kernels_line(kernel, main_path))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
