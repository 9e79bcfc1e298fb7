"""Protocol benchmark of the port: encrypted matches per second on one card.

Counterpart of ``scripts/bench_matches.py``.
  pairs:    B independent 1:1 matches (probe against template, Function_f
            and Function_g), all pairs in the same levelized bootstrap calls;
            --split runs them as that many sub-batches in one timed window;
  identify: one probe against N templates, threshold decisions
            (Server.identify);
  argmin:   one probe against N templates, encrypted tournament argmin
            (Server.identify_argmin).

The time is the wall clock from the first bootstrap call to the last
torch.cuda.synchronize(); the decisions are decrypted and checked against
the plaintext distances.  One JSON line a run, with the card's peak memory.

    python -m peba1_tpu_torch.bench_matches --config pairs --pairs 64
    python -m peba1_tpu_torch.bench_matches --config argmin --n-templates 64
    python -m peba1_tpu_torch.bench_matches --config identify --nslots 2 \
        --bitsize 3 --n-templates 4 --params toy --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import keys, lwe
from .params import PRESETS, ProtocolParams
from .protocol import ClientDevice, Server
from .utils import device as devinfo
from .utils.artifacts import atomic_json
from .utils.logging import stderr_log


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="encrypted matches/s on one card")
    ap.add_argument("--config", choices=["pairs", "identify", "argmin"], default="pairs")
    ap.add_argument("--params", default="peba1_128_t2_gen", choices=sorted(PRESETS))
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--split", type=int, default=1,
                    help="run the pairs as this many sequential sub-batches "
                         "(bounds the card's memory)")
    ap.add_argument("--n-templates", type=int, default=64)
    ap.add_argument("--nslots", type=int, default=128)
    ap.add_argument("--bitsize", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.split < 1 or args.pairs % args.split:
        ap.error("--pairs must divide by --split (>= 1)")
    return args


def main(argv=None, keyset=None) -> dict:
    """Run one configuration and print its JSON line; returns the record.
    `keyset`, a (secret key, cloud key) pair at --params on --device, skips
    keygen."""
    args = parse_args(argv)
    device = devinfo.require(args.device)
    log = stderr_log(bench="matches", config=args.config)
    proto = ProtocolParams(
        nslots=args.nslots, bitsize=args.bitsize, max_bitsize=3 * args.bitsize,
        mul_width=3 * args.bitsize - 1, bound_match=args.nslots * 2)
    tfhe = PRESETS[args.params]
    if keyset is None:
        with log.timer("keygen"):
            keyset = keys.keygen(torch.Generator(device=device).manual_seed(0), tfhe, device)
            devinfo.sync(device)
    sk, ck = keyset
    if ck.params != tfhe or sk.device != device:
        raise ValueError(f"the keyset given is not at {args.params} on {device}")
    client = ClientDevice(7, sk, ck, proto)
    server = Server(ck, proto)
    gens = [torch.Generator(device=device).manual_seed(i) for i in (1, 2, 3, 4)]

    rng = np.random.default_rng(0)
    hi = (1 << args.bitsize) - 1
    if args.config == "pairs":
        n_items = args.pairs
        templates = rng.integers(1, hi, (args.pairs, args.nslots))
        probes = templates + rng.integers(0, 2, templates.shape)      # near matches
        with log.timer("encrypt"):
            t_ct = client.encrypt_vector(gens[0], templates)
            p_ct = client.encrypt_vector(gens[1], probes)
            bound_ct = client.encrypt_word(
                gens[2], np.full(args.pairs, proto.bound_match), 3 * args.bitsize)
            devinfo.sync(device)
    else:
        n_items = args.n_templates
        templates = rng.integers(1, hi, (args.n_templates, args.nslots))
        probe = templates[min(3, args.n_templates - 1)] + 1   # near template 3 (or the last)
        with log.timer("encrypt"):
            t_ct = client.encrypt_vector(gens[0], templates)
            p_ct = client.encrypt_vector(gens[1], probe)
            bound_ct = client.encrypt_word(gens[2], proto.bound_match, 3 * args.bitsize)
            devinfo.sync(device)
        clear_d = ((templates - probe) ** 2).sum(1)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    server.be.launches = 0
    t0 = time.time()
    if args.config == "pairs":
        sub = args.pairs // args.split
        bs = []
        for h in range(args.split):
            sl = slice(h * sub, (h + 1) * sub)
            res = server.authenticate(gens[3], p_ct[sl], t_ct[sl], bound_ct[sl])
            devinfo.sync(device)
            bs.append(res.enc_b)
            if args.split > 1:
                print(f"[pairs] sub-batch {h + 1}/{args.split} done "
                      f"({time.time() - t0:.0f}s)", flush=True)
        dt = time.time() - t0
        b = client.decrypt_word(lwe.concatenate(bs, axis=0))
        want = (((probes - templates) ** 2).sum(1) > proto.bound_match).astype(int)
        correct = float((b == want).mean())
    elif args.config == "identify":
        out = server.identify(p_ct, t_ct, bound_ct)
        devinfo.sync(device)
        dt = time.time() - t0
        b = client.decrypt_word(out)
        correct = float((b == (clear_d > proto.bound_match)).mean())
    else:
        enc_d, enc_i = server.identify_argmin(p_ct, t_ct)
        devinfo.sync(device)
        dt = time.time() - t0
        d, i = int(client.decrypt_word(enc_d)), int(client.decrypt_word(enc_i))
        correct = float(d == int(clear_d.min()) and i == int(np.argmin(clear_d)))

    rec = {
        "metric": f"encrypted_{args.config}_matches_per_s",
        "value": n_items / dt,
        "unit": "matches/s",
        "seconds": dt,
        "items": n_items,
        "split": args.split if args.config == "pairs" else None,
        "launches": server.be.launches,
        "nslots": args.nslots,
        "bitsize": args.bitsize,
        "params": args.params,
        "correct_frac": correct,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "device": devinfo.name(device),
        "power_limit": devinfo.power_limit(device),
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        atomic_json(args.out, rec)
    return rec


if __name__ == "__main__":
    main()
