"""Checkpointed 1:N identification sweep at full width on one card.

Counterpart of ``scripts/sweep_identify.py``.  One encrypted probe against
N enrolled templates, in chunks of batched `Server.identify` calls, each
chunk's encrypted decision words written to disk (atomic writes, bound to
the sweep by the `sweep.IdentifySweep` fingerprint).  Run the same command
again after an interrupt and it resumes at the first missing chunk; the
record counts the chunks computed and resumed.  --max-chunks stops after
that many new chunks, to stage an interrupt.

Everything is deterministic from --seed: templates and probe (numpy), the
secret key, drawn from a CPU generator so that a finalize anywhere rebuilds
it, and the cloud key and encryptions.  The record (--out) is rewritten
atomically after every chunk; on completion the chunks are collected,
decrypted and checked against the plaintext distances.

    python -m peba1_tpu_torch.sweep_identify --n-templates 128 --chunk 32 \
        --dir runs/sweep --out sweep.json

--finalize computes nothing on any card: it rebuilds the secret key and the
plaintext expectations from --seed on the CPU, checks every chunk on disk
against the manifest's fingerprint, decrypts the decisions and writes the
record for a sweep in any state, with rates from the chunks' own seconds
(--merge-rates adds the chunk_seconds of earlier records).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import keys, lwe, sweep
from .backends import CountingBackend
from .io import serial
from .params import PRESETS, ProtocolParams
from .protocol import ClientDevice, Server
from .utils import device as devinfo
from .utils.artifacts import atomic_json
from .utils.logging import stderr_log

CLIENT_ID = 7


def make_inputs(args, proto):
    """The plaintext problem from --seed (shared by the sweep and finalize):
    templates, a probe near template N/3, and the expected decisions."""
    rng = np.random.default_rng(args.seed)
    hi = (1 << args.bitsize) - 1
    templates = rng.integers(1, hi + 1, (args.n_templates, args.nslots))
    # Clamped into the slot domain: hi + 1 would wrap to 0 in int_to_bits.
    probe = np.minimum(templates[args.n_templates // 3] + 1, hi)
    clear_d = ((templates - probe) ** 2).sum(1)
    want = (clear_d > proto.bound_match).astype(int)
    return templates, probe, want


def count_bootstraps_per_template(proto) -> int:
    """The gate bootstraps of Server.identify's circuit for one template,
    counted by running it once on plaintext bits."""
    from . import circuits as cc
    from .utils.bits import int_to_bits

    be = CountingBackend()
    t = int_to_bits(np.full((1, proto.nslots), 2), proto.bitsize, "cpu")
    p = int_to_bits(np.full((1, proto.nslots), 1), proto.bitsize, "cpu")
    bound = int_to_bits(np.array([proto.bound_match]), 3 * proto.bitsize, "cpu")
    cc.function_f(be, p, t, bound, proto.bitsize)
    return be.bootstraps


def steady_rates(chunk_seconds, chunk_templates, boots_per_template) -> dict:
    """`steady`: the median per-chunk rate (robust to the first chunk's
    build); `overall`: all timed templates over all timed seconds."""
    if not chunk_seconds:
        return {}
    rates = [chunk_templates[i] / s for i, s in chunk_seconds.items()]
    steady = float(np.median(rates))
    total_t = sum(chunk_templates[i] for i in chunk_seconds)
    total_s = sum(chunk_seconds.values())
    return {
        "templates_per_s_steady": steady,
        "templates_per_s_overall": total_t / total_s,
        "effective_bootstraps_per_s": steady * boots_per_template,
        "bootstraps_per_template": boots_per_template,
        "timed_chunks": len(chunk_seconds),
    }


def _moved(sk: keys.SecretKey, device) -> keys.SecretKey:
    return dataclasses.replace(sk, lwe_key=sk.lwe_key.to(device),
                               tlwe_key=sk.tlwe_key.to(device))


def _client(args, proto, device, with_cloud_key: bool) -> ClientDevice:
    """The client: its secret key from a CPU generator seeded by --seed (so
    it is the same wherever it is rebuilt), moved to `device`; the cloud key
    drawn on `device` from --seed + 1."""
    tfhe = PRESETS[args.params]
    sk = _moved(keys.secret_keygen(torch.Generator().manual_seed(args.seed), tfhe, "cpu"),
                device)
    ck = (keys.make_cloud_key(torch.Generator(device=device).manual_seed(args.seed + 1), sk)
          if with_cloud_key else None)
    return ClientDevice(CLIENT_ID, sk, ck, proto)


def _probe_and_bound(args, proto, client, probe):
    """The probe and bound ciphertexts, from one CPU generator seeded by
    --seed + 2, on the client's device."""
    gen = torch.Generator().manual_seed(args.seed + 2)
    cpu = ClientDevice(CLIENT_ID, _moved(client.sk, "cpu"), None, proto)
    p_ct = cpu.encrypt_vector(gen, probe)
    bound_ct = cpu.encrypt_word(gen, proto.bound_match, 3 * args.bitsize)
    dev = client.sk.device
    return (lwe.Lwe(p_ct.a.to(dev), p_ct.b.to(dev)),
            lwe.Lwe(bound_ct.a.to(dev), bound_ct.b.to(dev)))


def _joined(values) -> str | None:
    return ", ".join(sorted(v for v in values if v is not None)) or None


def _db_id(args) -> str:
    """The template database's identity: the generator's settings."""
    return f"seed{args.seed}-n{args.n_templates}-s{args.nslots}b{args.bitsize}"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="checkpointed 1:N identification sweep")
    ap.add_argument("--params", default="peba1_128_t2_gen", choices=sorted(PRESETS))
    ap.add_argument("--n-templates", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--nslots", type=int, default=128)
    ap.add_argument("--bitsize", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default="runs/sweep")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-chunks", type=int, default=0,
                    help="stop after computing this many new chunks in this "
                         "process (0: run to completion)")
    ap.add_argument("--finalize", action="store_true",
                    help="check and decrypt what is on disk and write the "
                         "record; computes nothing on any card")
    ap.add_argument("--merge-rates", action="append", default=[],
                    help="earlier records whose chunk_seconds feed the "
                         "finalize rates")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the sweep runs (finalize always runs on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    log = stderr_log(bench="sweep_identify")
    proto = ProtocolParams(
        nslots=args.nslots, bitsize=args.bitsize, max_bitsize=3 * args.bitsize,
        mul_width=3 * args.bitsize - 1, bound_match=args.nslots * 2)
    templates, probe, want = make_inputs(args, proto)
    if args.finalize:
        with log.timer("secret_keygen"):
            client = _client(args, proto, torch.device("cpu"), with_cloud_key=False)
        return finalize(args, proto, client, probe, want)

    device = devinfo.require(args.device)
    with log.timer("keygen"):
        client = _client(args, proto, device, with_cloud_key=True)
        devinfo.sync(device)
    server = Server(client.ck, proto)
    with log.timer("encrypt"):
        p_ct, bound_ct = _probe_and_bound(args, proto, client, probe)

    sw = sweep.IdentifySweep(server, args.dir, chunk=args.chunk, log=log)
    # The manifest is bound up front with the engine's fingerprint recipe, so
    # the chunk writes below carry the identity collect() checks.
    plan = sweep.SweepPlan(
        n_templates=args.n_templates, chunk=args.chunk,
        fingerprint=sweep._fingerprint(p_ct, bound_ct, args.n_templates, args.chunk,
                                       _db_id(args)))
    prev = sw._load_manifest()
    if prev is not None and prev != dataclasses.asdict(plan):
        raise SystemExit(f"checkpoint dir {args.dir} holds a different sweep; "
                         "use a fresh --dir")
    sw._write_manifest(plan)

    name, power = devinfo.name(device), devinfo.power_limit(device)
    chunk_times: "dict[str, float]" = {}
    pre_done = set(sw.completed_chunks())
    state = {"computed_this_run": 0, "resumed": len(pre_done)}
    t_start = time.time()

    def record(status):
        done = sw.completed_chunks()
        rec = {
            "metric": "identify_sweep_checkpointed",
            "status": status,
            "params": args.params,
            "n_templates": args.n_templates,
            "nslots": args.nslots, "bitsize": args.bitsize,
            "chunk": args.chunk,
            "chunks_done": len(done), "chunks_total": plan.n_chunks,
            "templates_done": min(len(done) * args.chunk, args.n_templates),
            "computed_this_run": state["computed_this_run"],
            "resumed_from_disk": state["resumed"],
            "chunk_seconds": chunk_times,
            "seconds_this_run": time.time() - t_start,
            "device": name,
            "power_limit": power,
            "sk_device": "cpu",
            "checkpoint_dir": args.dir,
        }
        if args.out:
            atomic_json(args.out, rec)
        return rec

    print(f"[sweep] {plan.n_chunks} chunks of {args.chunk}; "
          f"{len(pre_done)} already on disk (resume)", flush=True)
    for i in range(plan.n_chunks):
        if i in pre_done:
            continue
        lo, hi_t = plan.chunk_range(i)
        t0 = time.time()
        t_ct = client.encrypt_vector(
            torch.Generator(device=device).manual_seed(args.seed + 3 + i), templates[lo:hi_t])
        out = server.identify(p_ct, t_ct, bound_ct)
        devinfo.sync(device)
        dt = time.time() - t0
        sweep._atomic_save(sweep._chunk_path(args.dir, i), out,
                           {"chunk": i, "lo": lo, "hi": hi_t, "fingerprint": plan.fingerprint,
                            "seconds": dt, "device": name, "power_limit": power})
        chunk_times[str(i)] = dt
        state["computed_this_run"] += 1
        print(f"[sweep] chunk {i + 1}/{plan.n_chunks}: {dt:.0f}s "
              f"({(hi_t - lo) / dt:.4f} templates/s)", flush=True)
        record("running")
        if args.max_chunks and state["computed_this_run"] >= args.max_chunks:
            print(f"[sweep] stopping after {args.max_chunks} chunks (staged "
                  "interrupt); run again to resume", flush=True)
            return record("interrupted")

    # collect() checks every chunk's fingerprint against the manifest before
    # the decisions are decrypted and checked end to end.
    got = client.decrypt_word(sw.collect(device))
    rec = record("complete")
    rec["decisions_verified"] = int(got.shape[0])
    rec["correct_frac"] = float((got == want).mean())
    sizes = {i: min((int(i) + 1) * args.chunk, args.n_templates) - int(i) * args.chunk
             for i in chunk_times}
    rec.update(steady_rates(chunk_times, sizes, count_bootstraps_per_template(proto)))
    if args.out:
        atomic_json(args.out, rec)
    print(json.dumps(rec), flush=True)
    return rec


def finalize(args, proto, client, probe, want) -> dict:
    """Check and decrypt the on-disk state of a (possibly partial) sweep and
    write its record.  Touches no card."""
    # The probe and bound are drawn from CPU generators, so the fingerprint
    # recomputed here matches the manifest's byte for byte when this torch
    # draws as the sweep's did; otherwise the decryption pass below binds the
    # chunks to this sweep (every decision right under the seed's key).
    p_ct, bound_ct = _probe_and_bound(args, proto, client, probe)
    fp_local = sweep._fingerprint(p_ct, bound_ct, args.n_templates, args.chunk,
                                  _db_id(args))
    with open(os.path.join(args.dir, sweep.MANIFEST)) as f:
        plan = sweep.SweepPlan(**json.load(f))
    fp = plan.fingerprint
    fp_exact = fp_local == fp
    if not fp_exact:
        print(f"[finalize] recomputed fingerprint {fp_local} != manifest {fp}; "
              "relying on the decryption pass for binding", flush=True)

    chunk_seconds: "dict[str, float]" = {}
    for art in args.merge_rates:
        with open(art) as f:
            for i, s in json.load(f).get("chunk_seconds", {}).items():
                chunk_seconds[i] = float(s)
    chunk_templates: "dict[str, int]" = {}
    devices, powers = set(), set()
    n_verified = correct = 0
    for i in range(plan.n_chunks):
        path = sweep._chunk_path(args.dir, i)
        if not os.path.exists(path):
            continue
        ct, meta = serial.load_ciphertext(path, "cpu")
        if meta.get("fingerprint") != fp:
            raise SystemExit(f"chunk {i} fingerprint mismatch: "
                             f"{meta.get('fingerprint')} != {fp}")
        lo, hi_t = meta["lo"], meta["hi"]
        correct += int((client.decrypt_word(ct) == want[lo:hi_t]).sum())
        n_verified += hi_t - lo
        chunk_templates[str(i)] = hi_t - lo
        if "seconds" in meta:
            chunk_seconds[str(i)] = float(meta["seconds"])
        devices.add(meta.get("device"))
        powers.add(meta.get("power_limit"))
        print(f"[finalize] chunk {i}: fingerprint ok, {hi_t - lo} decisions decrypted",
              flush=True)

    n_present = len(chunk_templates)
    timed = {i: s for i, s in chunk_seconds.items() if i in chunk_templates}
    rec = {
        "metric": "identify_sweep_checkpointed",
        "status": "complete" if n_present == plan.n_chunks else
                  f"partial ({n_present}/{plan.n_chunks} chunks)",
        "finalize_mode": True,
        "params": args.params,
        "n_templates": args.n_templates,
        "nslots": args.nslots, "bitsize": args.bitsize,
        "chunk": args.chunk,
        "chunks_done": n_present,
        "chunks_total": plan.n_chunks,
        "templates_done": n_verified,
        "decisions_verified": n_verified,
        "correct_frac": (correct / n_verified) if n_verified else None,
        "fingerprint": fp,
        "fingerprint_match": "exact" if fp_exact else (
            "platform-divergent (the generators drew otherwise); binding "
            "established by the decryption pass"),
        "chunk_seconds": {i: chunk_seconds[i] for i in sorted(timed, key=int)},
        "device": _joined(devices),           # the devices that computed the chunks
        "power_limit": _joined(powers),
        "sk_device": "cpu",
        "finalize_device": "cpu",
        "checkpoint_dir": args.dir,
    }
    rec.update(steady_rates(timed, chunk_templates, count_bootstraps_per_template(proto)))
    if args.out:
        atomic_json(args.out, rec)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
