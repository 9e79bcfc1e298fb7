"""Multi-rank dry run of the parallel layer, asserted against plaintext.

Counterpart of ``__graft_entry__.dryrun_multichip(n)``, with its mesh rule,
shapes and assertions.  A world of n ranks, mesh ('dp', 'tp') = (n / tp, tp)
with tp = 2 when n is even, every rank holding the same keys (a generator
seeded 0 on its device) and the same inputs:

  1. ``sharded_bootstrap`` on 4n rows of alternating bits, decrypting to
     the bits;
  2. ``sharded_bootstrap_ringtp`` with ``overlap_blocks`` 1 and 2 (when tp
     divides N), decrypting to the bits;
  3. ``gspmd_identify`` and ``gspmd_identify_argmin`` on n templates of one
     slot of 2 bits drawn in [1, 3], the probe template n // 2, bound 0:
     the verdicts, the argmin and its distance against the plaintext.

The ranks are spawned processes joined by a ``file://`` store, as in
``bench_scaling``: NCCL with one card a rank (``--device cuda``, n at most
the cards), gloo over CPU processes (``--device cpu``), or, only with
``--share-card``, gloo with the ranks on the cards, several to a card.  The
last is the card's counterpart of JAX's virtual CPU mesh: the collectives
go through the host, so its times are not interconnect times.  More ranks
than cards without ``--share-card`` raises.  Each rank counts its kernel
launches per check; one JSON line at the end.  A failed check fails its
rank, and the command exits non-zero.

    python -m peba1_tpu_torch.dryrun --world 2 --device cpu
    python -m peba1_tpu_torch.dryrun --world 4 --share-card
    python -m peba1_tpu_torch.dryrun --world 4 --share-card --params peba1_128_t2_gen
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .params import PRESETS
from .utils import device as devinfo
from .utils.artifacts import atomic_json

WORLD_TIMEOUT_S = 900      # a world still running after this is killed
NSLOTS, BITSIZE, BOUND = 1, 2, 0


class DryRunFailure(AssertionError):
    pass


def mesh_shape(world: int) -> "tuple[int, int]":
    """(n_dp, n_tp) of a world: tp = 2 when the world is even, as JAX's."""
    n_tp = 2 if world % 2 == 0 else 1
    return world // n_tp, n_tp


def choose_backend(device: str, world: int, share_card: bool) -> str:
    """The backend of a world of `world` ranks on `device`: gloo on the CPU;
    on the card NCCL (one rank a card), or gloo when the caller shares the
    cards.  More ranks than cards without `share_card` raises."""
    if device == "cpu":
        return "gloo"
    devinfo.require(device)
    if share_card:
        return "gloo"
    cards = torch.cuda.device_count()
    if world > cards:
        raise SystemExit(f"--world {world} needs {world} cards for NCCL (one rank a card) "
                         f"and there are {cards}: pass --share-card to put the ranks on "
                         "the cards over gloo")
    return "nccl"


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise DryRunFailure(what)


def _rank_main(rank: int, world: int, args: dict, store: str, out: str) -> None:
    """One rank: keys, the three groups of checks, and its report; the
    first rank gathers the reports and writes the record to `out`."""
    import torch.distributed as dist

    from . import circuits as cc
    from . import gates, keys
    from .ops import cuda_kernels
    from .parallel import mesh as pmesh
    from .parallel import shard as pshard
    from .params import ProtocolParams
    from .protocol import Server
    from .utils.bits import bits_to_int, int_to_bits

    a = argparse.Namespace(**args)
    if a.device == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    device = pmesh.init_distributed(f"file://{store}", world, rank, device=a.device,
                                    backend=a.backend)
    n_dp, n_tp = mesh_shape(world)
    mesh = pmesh.make_mesh(n_dp, n_tp, device=device)
    p = PRESETS[a.params]
    sk, ck = keys.keygen(torch.Generator(device=device).manual_seed(0), p, device)
    report = {"launches": {}, "seconds": {}}

    def run(name, fn):
        cuda_kernels.reset_launches()
        t0 = time.time()
        res = fn()
        devinfo.sync(device)
        report["seconds"][name] = time.time() - t0
        report["launches"][name] = {k: n for k, n in cuda_kernels.launches.items() if n}
        return res

    def decrypt(ct):
        return gates.decrypt_bits(ct, sk).cpu().numpy()

    mu = gates.MU_1_8
    bits = np.arange(4 * world) % 2
    ct = gates.encrypt_bits(torch.Generator(device=device).manual_seed(1), sk, bits)
    out_ct = run("sharded_bootstrap", lambda: pshard.sharded_bootstrap(mesh, ck, ct, mu))
    expect((decrypt(out_ct) == bits).all(), "sharded_bootstrap decrypts to wrong bits")
    if p.N % n_tp == 0:
        for K in (1, 2):
            out_ct = run(f"ringtp_k{K}", lambda: pshard.sharded_bootstrap_ringtp(
                mesh, ck, ct, mu, overlap_blocks=K))
            expect((decrypt(out_ct) == bits).all(),
                   f"sharded_bootstrap_ringtp with overlap_blocks={K} decrypts to wrong bits")

    # Nonzero slot values only: a zero probe slot meets the reference's
    # sub_abs forced-sign quirk, where the plaintext expectation does not hold.
    n_templates = world
    tmpl = np.random.default_rng(5).integers(1, 1 << BITSIZE, (n_templates, NSLOTS))
    probe = tmpl[n_templates // 2]
    gen = torch.Generator(device=device).manual_seed(2)
    t_ct = gates.encrypt_bits(gen, sk, int_to_bits(tmpl, BITSIZE, device))
    p_ct = gates.encrypt_bits(gen, sk, int_to_bits(probe, BITSIZE, device))
    server = Server(ck, ProtocolParams(nslots=NSLOTS, bitsize=BITSIZE,
                                       max_bitsize=3 * BITSIZE, mul_width=3 * BITSIZE - 1,
                                       bound_match=BOUND))
    enc_bound = cc.const_word(server.be, BOUND, 3 * BITSIZE)
    d = ((tmpl - probe) ** 2).sum(1)
    verdicts = run("gspmd_identify", lambda: pshard.gspmd_identify(
        mesh, server, p_ct, t_ct, enc_bound))
    got_b = bits_to_int(decrypt(verdicts))
    expect((got_b == (d > BOUND)).all(), f"gspmd_identify verdicts {got_b} for distances {d}")
    enc_d, enc_i = run("gspmd_identify_argmin", lambda: pshard.gspmd_identify_argmin(
        mesh, server, p_ct, t_ct))
    got_i, got_d = int(bits_to_int(decrypt(enc_i))), int(bits_to_int(decrypt(enc_d)))
    expect(got_i == int(np.argmin(d)), f"gspmd_identify_argmin index {got_i} for {d}")
    expect(got_d == int(d.min()), f"gspmd_identify_argmin distance {got_d} for {d}")

    reports = [None] * world
    dist.all_gather_object(reports, report)
    if rank == 0:
        atomic_json(out, {
            "world": world, "mesh": [n_dp, n_tp], "backend": dist.get_backend(),
            "device": devinfo.name(device), "power_limit": devinfo.power_limit(device),
            "params": a.params, "checks": list(report["seconds"]),
            "distances": d.tolist(), "argmin": got_i, "min": got_d,
            "launches": [r["launches"] for r in reports],
            "check_seconds": {k: max(r["seconds"][k] for r in reports)
                              for k in report["seconds"]}})
    dist.barrier()
    dist.destroy_process_group()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="multi-rank dry run of the parallel layer")
    ap.add_argument("--world", type=int, default=2, help="ranks")
    ap.add_argument("--params", default="toy", choices=sorted(PRESETS),
                    help="default toy, the JAX dry run's; a kernel preset launches "
                         "its kernel on every rank")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--share-card", action="store_true",
                    help="put the ranks on the cards over gloo, several to a card")
    args = ap.parse_args(argv)
    if args.world < 1:
        ap.error("--world must be at least 1")
    if args.share_card and args.device != "cuda":
        ap.error("--share-card is for --device cuda")
    return args


def main(argv=None) -> dict:
    import torch.multiprocessing as mp

    args = parse_args(argv)
    args.backend = choose_backend(args.device, args.world, args.share_card)
    if args.device == "cuda":
        from .ops import cuda_kernels
        cuda_kernels.build()            # once here, not once a rank
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "record.json")
        ctx = mp.start_processes(_rank_main, args=(args.world, vars(args),
                                                   os.path.join(tmp, "store"), out),
                                 nprocs=args.world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.time() - t0 > WORLD_TIMEOUT_S:
                    raise TimeoutError(f"the world of {args.world} ranks ran past "
                                       f"{WORLD_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        with open(out) as f:
            rec = json.load(f)
    rec["seconds"] = time.time() - t0
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
