"""Multi-device scaling benchmark of the port's parallel layer.

Counterpart of ``scripts/bench_scaling.py``.  Weak scaling of the sharded
protocol paths: fixed work per rank, the mesh grown over dp; efficiency(n) =
t(1) / t(n) (ideal weak scaling keeps the wall time flat).

  --mode bootstrap   parallel.shard.sharded_bootstrap (a gate-bootstrap
                     batch per rank)
  --mode identify    parallel.shard.sharded_identify (a template shard of
                     the whole encrypted-distance and threshold circuit per
                     rank)
  --mode comm        static collective-payload arithmetic: no device runs

For each size in --sizes it starts a world of that many ranks times --n-tp
(torch.multiprocessing, spawn, one card per rank on NCCL; gloo over CPU
processes with --device cpu), skipping sizes above the cards present (the
CPU's cores with --device cpu).  Every rank makes the same keys and inputs
from the seed; each rep is timed on fresh encryptions from the first rank's
barrier to the slowest rank's synchronize, and the min of --reps is kept
after one warm-up.  Every result is decrypted and checked.  --out is
rewritten after each size; one JSON line at the end.

    python -m peba1_tpu_torch.bench_scaling --mode bootstrap --params \\
        peba1_128_t2_gen --per-device-batch 8192 --sizes 1,2,4,8
    python -m peba1_tpu_torch.bench_scaling --mode comm
    python -m peba1_tpu_torch.bench_scaling --params toy --sizes 1,2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .params import PRESETS
from .utils import device as devinfo
from .utils.artifacts import atomic_json

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# comm-mode defaults: the port's own numbers from its records on the card,
# and the link's datasheet rate (assumed, not measured).
BATCH_SECONDS = 8192 / 34756.91
BATCH_SECONDS_SOURCE = (f"H100_BENCH.json peba1_128_t2_gen: 8192 / 34,756.91 "
                        f"bootstraps/s ({CARD})")
TEMPLATE_SECONDS = 1 / 0.16170554932298342
TEMPLATE_SECONDS_SOURCE = (f"H100_SWEEP.json: 1 / 0.1617 templates/s steady, "
                           f"peba1_128_t2_gen, nslots 128, bitsize 8 ({CARD})")
RINGTP_GEMM_FRAC = 0.2819889506741025
RINGTP_GEMM_FRAC_SOURCE = (f"H100_SCALING.json ringtp_share: chip_smoke.phase_parallel at "
                           f"peba1_128_t2_gen, 184 rows, tp=1: 630 column products "
                           f"344.16 ms of a 1,220.49 ms ring-TP call ({CARD})")
NVLINK_GBPS = 450.0
NVLINK_SOURCE = ("assumed: H100 SXM5 NVLink 4, 900 GB/s bidirectional = 450 GB/s "
                 "per direction (NVIDIA datasheet), not measured")
NETWORK_GBPS = 50.0
NETWORK_SOURCE = ("assumed: one 400 Gb/s NDR InfiniBand NIC per card "
                  "(NVIDIA DGX H100 datasheet), not measured")


def mode_comm(args) -> dict:
    """Static collective-payload accounting and projected link-limited
    efficiency of the sharded forms.

    Per-collective payloads are known statically from parallel/shard.py;
    per-rank compute times come from the port's records on the card; the
    efficiency is t_compute / (t_compute + t_comm) with no overlap of the
    two, a lower bound (the ring-TP per-step gather sits on the serial
    accumulator path, so there it is tight).  The link rates are knobs:
    --nvlink-gbps within a node, --network-gbps across nodes.
    """
    p = PRESETS[args.params]
    B = args.comm_batch                      # bootstrap batch per rank
    nslots, bits = args.nslots, args.bitsize
    nvlink, net = args.nvlink_gbps * 1e9, args.network_gbps * 1e9
    ct_bytes = (p.n + 1) * 4                 # one LWE ciphertext
    ks_cols = (p.n + 1) * 4                  # keyswitch table output columns
    t_batch, t_template = args.batch_seconds, args.template_seconds
    f_gemm, K = args.ringtp_gemm_frac, args.overlap_blocks

    def eff(t_comp, t_comm):
        return t_comp / (t_comp + t_comm)

    rows = []
    for tp in (2, 4, 8):
        # sharded_bootstrap: one all_gather a call, the tp keyswitch partials
        # (int32 (B, C/tp), gathered tiled).  Bytes received per rank:
        cpad = -(-ks_cols // tp) * tp
        bytes_ks = B * cpad * 4 * (tp - 1) / tp
        rows.append({
            "form": "sharded_bootstrap", "axis": f"tp={tp}", "link": "nvlink",
            "payload_bytes_per_device_per_launch": int(bytes_ks),
            "t_compute_s": t_batch, "t_comm_s": bytes_ks / nvlink,
            "projected_efficiency": eff(t_batch, bytes_ks / nvlink),
        })
    for tp in (2, 4, 8):
        # sharded_bootstrap_ringtp: an all_gather of the step's int32 delta
        # slice ((B, k+1, N/tp) -> (B, k+1, N)) on each of the n serial
        # steps.  Three models: optimistic (the whole call divides by tp);
        # corrected (only the column product's share f divides, the rotation
        # and the digits run on every rank); corrected + overlap_blocks=K
        # (all but ~1/K of the gather hidden behind the next block's product).
        bytes_step = B * (p.k + 1) * p.N * 4 * (tp - 1) / tp
        total = bytes_step * p.n
        t_comm = total / nvlink
        t_ideal = t_batch / tp
        t_corr = t_batch * (f_gemm / tp + (1 - f_gemm))
        t_gemm_local = t_batch * f_gemm / tp
        t_comm_exposed = max(t_comm / K, t_comm - (K - 1) / K * t_gemm_local)
        rows.append({
            "form": "sharded_bootstrap_ringtp", "axis": f"tp={tp}", "link": "nvlink",
            "payload_bytes_per_device_per_batch": int(total),
            "t_compute_s": t_ideal, "t_comm_s": t_comm,
            "projected_efficiency": eff(t_ideal, t_comm),
        })
        rows.append({
            "form": "sharded_bootstrap_ringtp_corrected", "axis": f"tp={tp}",
            "link": "nvlink", "gemm_fraction": f_gemm,
            "t_compute_s": t_corr, "t_comm_s": t_comm,
            "projected_efficiency_vs_ideal": t_ideal / (t_corr + t_comm),
        })
        rows.append({
            "form": "sharded_bootstrap_ringtp_overlap", "axis": f"tp={tp}",
            "link": "nvlink", "gemm_fraction": f_gemm, "overlap_blocks": K,
            "t_compute_s": t_corr, "t_comm_exposed_s": t_comm_exposed,
            "projected_efficiency_vs_ideal": t_ideal / (t_corr + t_comm_exposed),
        })
    for nodes in (2, 4, 8):
        # sharded_identify over dp across nodes: no collective inside the
        # circuit; the replicated probe and bound reach every node once an
        # authentication, over the network.
        bytes_bcast = (nslots * bits + 3 * bits) * ct_bytes
        t_comm = bytes_bcast / net
        rows.append({
            "form": "sharded_identify", "axis": f"nodes={nodes} (dp)", "link": "network",
            "payload_bytes_per_probe": int(bytes_bcast),
            "t_compute_s": t_template, "t_comm_s": t_comm,
            "projected_efficiency": eff(t_template, t_comm),
        })
    rows.append({
        "form": "sharded_tree_sum/argmin finalists", "axis": "tp or dp", "link": "nvlink",
        "payload_bytes_per_reduce": int(3 * bits * ct_bytes),
        "note": "a few encrypted words against seconds of compute; negligible",
    })

    def row(form, axis):
        return next(r for r in rows if r["form"] == form and r["axis"] == axis)

    r_ident = row("sharded_identify", "nodes=2 (dp)")
    r_ks = row("sharded_bootstrap", "tp=2")
    r_ring = row("sharded_bootstrap_ringtp", "tp=2")
    r_ring_c = row("sharded_bootstrap_ringtp_corrected", "tp=2")
    r_ring_o = row("sharded_bootstrap_ringtp_overlap", "tp=2")
    rec = {
        "metric": "projected_interconnect_limited_efficiency",
        "model": "t_comp/(t_comp+t_comm), no-overlap lower bound; ringtp also "
                 "with the corrected compute split and with chunked-gather overlap",
        "params": args.params,
        "per_device_batch": B,
        "nslots": nslots, "bitsize": bits,
        "assumed_nvlink_gbytes_per_s": args.nvlink_gbps,
        "nvlink_source": NVLINK_SOURCE,
        "assumed_network_gbytes_per_s": args.network_gbps,
        "network_source": NETWORK_SOURCE,
        "batch_seconds": t_batch,
        "batch_seconds_source": args.batch_seconds_source,
        "template_seconds": t_template,
        "template_seconds_source": args.template_seconds_source,
        "ringtp_gemm_frac": f_gemm,
        "ringtp_gemm_frac_source": args.ringtp_gemm_frac_source,
        "rows": rows,
        "verdict": (
            f"dp scaling is collective-free: sharded_identify over 2 nodes projects "
            f"{r_ident['projected_efficiency']:.6f} (the probe broadcast is microseconds "
            f"against {t_template:.2f} s a template), and the tp-split keyswitch "
            f"{r_ks['projected_efficiency']:.4f} at tp=2.  Ring-TP's per-step gather is "
            f"on the serial accumulator path: {r_ring['projected_efficiency']:.4f} at "
            f"tp=2 optimistic, {r_ring_c['projected_efficiency_vs_ideal']:.4f} with only "
            f"the column product ({f_gemm:.4f} of a call) split, "
            f"{r_ring_o['projected_efficiency_vs_ideal']:.4f} with overlap_blocks={K}."),
    }
    return rec


def _rank_main(local_rank: int, world: int, args: dict, store: str, out: str) -> None:
    """One rank of a world of `world` (spawned): keys, inputs, the warm-up
    and the timed reps; the first rank writes the result to `out`."""
    import torch.distributed as dist

    from . import circuits as cc
    from . import gates, keys
    from .backends import CipherBackend
    from .parallel import mesh as pmesh
    from .parallel import shard as pshard
    from .utils.bits import bits_to_int, int_to_bits

    a = argparse.Namespace(**args)
    if a.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = pmesh.init_distributed(f"file://{store}", world, local_rank, device=a.device)
    mesh = pmesh.make_mesh(world // a.n_tp, a.n_tp, device=device)
    n = world // a.n_tp
    p = PRESETS[a.params]
    sk, ck = keys.keygen(torch.Generator(device=device).manual_seed(0), p, device)
    rng = np.random.default_rng(0)

    def timed(fn):
        dist.barrier()
        devinfo.sync(device)
        t0 = time.time()
        res = fn()
        devinfo.sync(device)
        dt = torch.tensor([time.time() - t0], dtype=torch.float64, device=device)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)        # the slowest rank's
        return res, float(dt)

    def run_bootstrap(seed):
        bits = rng.integers(0, 2, a.per_device_batch * n)
        ct = gates.encrypt_bits(torch.Generator(device=device).manual_seed(seed), sk, bits)
        out_ct, dt = timed(lambda: pshard.sharded_bootstrap(mesh, ck, ct, gates.MU_1_8))
        got = gates.decrypt_bits(out_ct, sk).cpu().numpy()
        if not (got == bits).all():
            raise RuntimeError(f"wrong bits at n={n}")
        return dt, len(bits)

    def run_identify(seed):
        nt = a.per_device_templates * n
        hi = (1 << a.bitsize) - 1
        # Nonzero slot values only: a zero operand meets the reference's
        # sub_abs quirk, where the plaintext expectation below does not hold.
        tmpl = rng.integers(1, hi + 1, (nt, a.nslots))
        probe = tmpl[nt // 2]
        gen = torch.Generator(device=device).manual_seed(seed)
        t_ct = gates.encrypt_bits(gen, sk, int_to_bits(tmpl, a.bitsize, device))
        p_ct = gates.encrypt_bits(gen, sk, int_to_bits(probe, a.bitsize, device))
        bound = cc.const_word(CipherBackend(ck), 2 * a.nslots, 3 * a.bitsize)
        out_ct, dt = timed(lambda: pshard.sharded_identify(mesh, ck, p_ct, t_ct, bound,
                                                           a.bitsize))
        got = bits_to_int(gates.decrypt_bits(out_ct, sk))
        want = (((tmpl - probe) ** 2).sum(1) > 2 * a.nslots).astype(int)
        if not (got == want).all():
            raise RuntimeError(f"wrong verdicts at n={n}")
        return dt, nt

    run = {"bootstrap": run_bootstrap, "identify": run_identify}[a.mode]
    run(1000 + n)                                        # warm-up
    reps = [run(2000 + 10 * n + r) for r in range(a.reps)]
    if dist.get_rank() == 0:
        atomic_json(out, {"seconds": min(t for t, _ in reps), "verified": sum(v for _, v in reps),
                          "device": devinfo.name(device),
                          "power_limit": devinfo.power_limit(device),
                          "backend": dist.get_backend()})
    dist.barrier()
    dist.destroy_process_group()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="weak scaling of the sharded paths")
    ap.add_argument("--params", default=None, choices=sorted(PRESETS),
                    help="default: toy, and peba1_128_t2_gen (the preset of the "
                         "records the comm defaults come from) with --mode comm")
    ap.add_argument("--mode", choices=["bootstrap", "identify", "comm"], default="bootstrap")
    ap.add_argument("--per-device-batch", type=int, default=64,
                    help="gate bootstraps per rank (bootstrap mode)")
    ap.add_argument("--per-device-templates", type=int, default=2,
                    help="templates per rank (identify mode)")
    ap.add_argument("--nslots", type=int, default=2)
    ap.add_argument("--bitsize", type=int, default=3)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--n-tp", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    # comm-mode knobs (static accounting; no device is touched)
    ap.add_argument("--comm-batch", type=int, default=8192,
                    help="bootstrap batch per rank for the comm model")
    ap.add_argument("--nvlink-gbps", type=float, default=NVLINK_GBPS,
                    help="per-direction GB/s between the cards of a node")
    ap.add_argument("--network-gbps", type=float, default=NETWORK_GBPS,
                    help="per-card GB/s between nodes")
    ap.add_argument("--batch-seconds", type=float, default=BATCH_SECONDS,
                    help="seconds of one bootstrap batch of --comm-batch on one card")
    ap.add_argument("--batch-seconds-source", default=BATCH_SECONDS_SOURCE)
    ap.add_argument("--template-seconds", type=float, default=TEMPLATE_SECONDS,
                    help="seconds of one 1:N template on one card")
    ap.add_argument("--template-seconds-source", default=TEMPLATE_SECONDS_SOURCE)
    ap.add_argument("--ringtp-gemm-frac", type=float, default=RINGTP_GEMM_FRAC,
                    help="share of a ring-TP call in the column product (the "
                         "part that divides by tp)")
    ap.add_argument("--ringtp-gemm-frac-source", default=RINGTP_GEMM_FRAC_SOURCE)
    ap.add_argument("--overlap-blocks", type=int, default=4,
                    help="chunked-gather blocks for the ringtp overlap row")
    args = ap.parse_args(argv)
    if args.params is None:
        args.params = "peba1_128_t2_gen" if args.mode == "comm" else "toy"
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode == "comm":
        rec = mode_comm(args)
        print(json.dumps(rec), flush=True)
        if args.out:
            atomic_json(args.out, rec)
        return rec

    import tempfile

    import torch.multiprocessing as mp

    device = devinfo.require(args.device)
    available = torch.cuda.device_count() if device.type == "cuda" else os.cpu_count() or 1
    times, info = {}, {}

    def make_record():
        base = times[min(times)]
        return {
            "metric": f"weak_scaling_efficiency_{args.mode}",
            "unit": "t1/tn (1.0 = ideal)",
            "mode": args.mode,
            "per_device_batch": args.per_device_batch,
            "per_device_templates": args.per_device_templates,
            "nslots": args.nslots, "bitsize": args.bitsize, "n_tp": args.n_tp,
            "params": args.params,
            "reps": args.reps,
            "times_s": {str(k): v for k, v in times.items()},
            "efficiency": {str(k): base / v for k, v in times.items()},
            "verified": {str(k): i["verified"] for k, i in info.items()},
            "virtual_cpu_mesh": device.type == "cpu",
            "caveat": ("CPU ranks over gloo: times include host-core contention, not "
                       "interconnect" if device.type == "cpu" else None),
            "backend": info[min(info)]["backend"],
            "device": info[min(info)]["device"],
            "power_limit": info[min(info)]["power_limit"],
        }

    for n in [int(s) for s in args.sizes.split(",")]:
        world = n * args.n_tp
        if world > available:
            print(f"skip n={n}: only {available} {device.type} devices", file=sys.stderr)
            continue
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.json")
            mp.start_processes(_rank_main, args=(world, vars(args), os.path.join(tmp, "store"),
                                                 out),
                               nprocs=world, start_method="spawn")
            with open(out) as f:
                info[n] = json.load(f)
        times[n] = info[n]["seconds"]
        print(f"n={n}: {times[n]:.3f}s (min of {args.reps})", file=sys.stderr, flush=True)
        # Rewritten after each size: a cut run keeps the sizes measured so far.
        if args.out:
            atomic_json(args.out, make_record())

    if not times:
        raise SystemExit(f"no size of {args.sizes} fits {available} {device.type} devices")
    rec = make_record()
    print(json.dumps(rec), flush=True)
    if args.out:
        atomic_json(args.out, rec)
    return rec


if __name__ == "__main__":
    main()
