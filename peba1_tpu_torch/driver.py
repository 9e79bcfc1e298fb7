"""Reference-style driver: the peba1 binary's self-test suite, on PyTorch.

Counterpart of ``peba1_tpu/driver.py``: key setup, test vectors, an
encrypt/decrypt round-trip gate, the plaintext suite, the ciphertext suite,
and the full encrypted protocol run, with per-phase wall timings.

Run:  python -m peba1_tpu_torch [--params peba1_128_t2_gen] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import circuits as cc
from . import clear, gates, keys
from .backends import CipherBackend
from .params import PRESETS, ProtocolParams
from .protocol import ClientDevice, Server
from .utils import device as devinfo
from .utils.bits import bits_to_int


def generator(device, seed: int) -> torch.Generator:
    """A seeded torch.Generator on `device`."""
    return torch.Generator(device=device).manual_seed(seed)


class _Timer:
    def __init__(self, device: torch.device):
        self.device = device
        self.t = time.time()

    def lap(self) -> float:
        devinfo.sync(self.device)
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt


def run(params_name: str = "toy", nslots: int = 128, bitsize: int = 8,
        loop: int = 128, seed: int = 42, skip_cipher_suite: bool = False,
        device="cuda") -> dict:
    device = torch.device(device)
    results: dict = {}
    tfhe = PRESETS[params_name]
    proto = ProtocolParams(nslots=nslots, bitsize=bitsize,
                           max_bitsize=3 * bitsize, mul_width=3 * bitsize - 1,
                           bound_match=nslots * 2)
    tm = _Timer(device)

    # --- key/param setup --------------------------------------------------
    sk, ck = keys.keygen(generator(device, seed), tfhe, device)
    print(f"[keys] generated ({params_name}) in {tm.lap():.1f}s")
    g_enc = generator(device, seed + 1)
    g_auth = generator(device, seed + 2)

    # --- test vectors -----------------------------------------------------
    rng = np.random.default_rng(seed)
    hi = (1 << bitsize) - 1
    template = rng.integers(1, hi, nslots)
    sample_true = template + 1                      # ED = nslots
    sample_false = rng.integers(1, hi + 1, nslots)
    print(f"[vectors] nslots={nslots} bitsize={bitsize}")

    # --- enc/dec round-trip gate ------------------------------------------
    client = ClientDevice(7, sk, ck, proto)
    server = Server(ck, proto)
    enc_template = client.encrypt_vector(g_enc, template)
    enc_true = client.encrypt_vector(g_enc, sample_true)
    enc_false = client.encrypt_vector(g_enc, sample_false)
    ok = ((client.decrypt_word(enc_template) == template).all()
          and (client.decrypt_word(enc_true) == sample_true).all()
          and (client.decrypt_word(enc_false) == sample_false).all())
    results["roundtrip"] = bool(ok)
    print(f"[enc/dec] correctness {'succeeds' if ok else 'FAILS'} ({tm.lap():.1f}s)")
    if not ok:
        raise SystemExit("encryption round-trip failed")

    # --- plaintext suite: each op's `loop` cases as one batch --------------
    t64 = template.astype(np.uint64)
    s64 = sample_true.astype(np.uint64)
    px = rng.integers(1, hi + 1, loop).astype(np.uint64)
    py = rng.integers(1, hi + 1, loop).astype(np.uint64)
    checks = {
        "add": (clear.add_nbit(px, py, 64) == px + py).mean(),
        "twos_complement": (clear.twos_complement(px, 64) == (-px)).mean(),
        "abs": (clear.abs_(px, 64) == px).mean(),
        "sub": (clear.sub_nbit(px, py, 64) == np.abs(px.astype(np.int64) - py.astype(np.int64)).astype(np.uint64)).mean(),
        "multiply": (clear.multiply(px, py, bitsize) == px * py).mean(),
        "manhattan": float(clear.manhattan_distance_bitwise(t64, s64, 64) == clear.manhattan_distance(template, sample_true)),
        "euclidean": float(clear.euclidean_distance_bitwise(t64, s64, 64) == clear.euclidean_distance(template, sample_true)),
    }
    results["plaintext_suite"] = {k: float(v) for k, v in checks.items()}
    all_ok = all(v == 1.0 for v in checks.values())
    print(f"[plaintext suite] {'all pass' if all_ok else checks} "
          f"(loop={loop}, {tm.lap():.3f}s)")

    bound = int(proto.bound_match)
    f_clear = clear.function_f_clear(t64, s64, bound, 64)
    y_clear = clear.function_g_clear(f_clear, 17, 99, 64)
    results["protocol_clear"] = {"f": int(f_clear), "y==r1": bool(y_clear == 99)}
    print(f"[plaintext protocol] f={int(f_clear)} (ED={int(clear.euclidean_distance(template, sample_true))} vs bound={bound})")

    # --- ciphertext suite, each op's `loop` cases as one batch -------------
    if not skip_cipher_suite:
        be = CipherBackend(ck)
        cx = rng.integers(1, hi + 1, loop)
        cy = rng.integers(1, hi + 1, loop)
        ex = client.encrypt_vector(g_enc, cx)
        ey = client.encrypt_vector(g_enc, cy)
        suite: dict = {}

        def dec(ct):
            return bits_to_int(gates.decrypt_bits(ct, sk))

        def record(name, got, want):
            ok = (got == np.asarray(want, got.dtype)).mean()
            dt = tm.lap()
            suite[name] = {"correct": float(ok), "seconds": round(dt, 3)}
            print(f"[cipher] {name}: {ok*100:.1f}% ({dt:.1f}s, "
                  f"{be.launches} launches)")

        mod = 1 << bitsize
        s, _ = cc.add_n(be, ex, ey, bitsize)
        record("add", dec(s), (cx + cy) % mod)
        tc = cc.twos_complement(be, ex, bitsize)
        record("twos_complement", dec(tc), (-cx) % mod)
        ab = cc.abs_n(be, ex, bitsize)
        record("abs", dec(ab), np.where(cx < mod // 2, cx, mod - cx))
        sub = cc.sub_abs(be, ex, ey, bitsize)
        record("sub_abs", dec(sub), np.abs(cx.astype(int) - cy.astype(int)))
        mul = cc.multiply(be, ex, ey, bitsize, length=proto.mul_width)
        record("multiply", dec(mul),
               (cx.astype(np.int64) * cy) % (1 << proto.mul_width))
        mn, gt = cc.minimum(be, ex, ey, bitsize)
        mn_ok = dec(mn) == np.minimum(cx, cy)
        gt_ok = dec(gt) == (cx > cy).astype(np.int64)
        record("minimum", (mn_ok & gt_ok), True)
        man = cc.manhattan(be, enc_true, enc_template, bitsize)
        record("he_manhattan", dec(man[..., :bitsize]),
               int(clear.manhattan_distance(template, sample_true)) % mod)
        euc = cc.euclidean(be, enc_true, enc_template, bitsize,
                           max_bitsize=proto.max_bitsize)
        record("he_euclidean", dec(euc),
               int(clear.euclidean_distance(template, sample_true))
               % (1 << (proto.max_bitsize - 1)))
        results["cipher_suite"] = suite

    # --- encrypted protocol -----------------------------------------------
    rec = client.enroll(g_enc, template)
    server.register(rec)
    enc_bound = client.encrypt_word(g_enc, bound, 3 * bitsize)
    devinfo.sync(device)
    t0 = time.time()
    res = server.authenticate(g_auth, enc_true, rec.template_ct, enc_bound)
    devinfo.sync(device)
    t_auth = time.time() - t0
    y = client.prove(res.enc_y)
    b = int(client.decrypt_word(res.enc_b))
    v = server.verify_proof(res, y)
    ed = int(clear.euclidean_distance(template, sample_true))
    results["protocol"] = {
        "ed": ed, "bound": bound, "b": b,
        "y": int(y), "r0": int(res.r0), "r1": int(res.r1),
        "reference_verdict(y==r1)": bool(v["reference_verdict"]),
        "is_match": bool(v["is_match"]),
        "seconds": t_auth,
    }
    expect_b = 1 if ed > bound else 0
    status = "OK" if b == expect_b else "MISMATCH"
    print(f"[protocol] ED={ed} bound={bound} b={b} ({status}); y={int(y)} "
          f"r0={int(res.r0)} r1={int(res.r1)}; Function_f+g in {t_auth:.1f}s")
    print(f"[protocol] faithful driver verdict (y==r1): {bool(v['reference_verdict'])}; "
          f"semantic is_match: {bool(v['is_match'])}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="PEBA1 reference-style driver (PyTorch)")
    ap.add_argument("--params", default="peba1_128_t2_gen", choices=sorted(PRESETS))
    ap.add_argument("--nslots", type=int, default=128)
    ap.add_argument("--bitsize", type=int, default=8)
    ap.add_argument("--loop", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--skip-cipher-suite", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write the results dict as a JSON artifact")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    devinfo.require(args.device)
    results = run(args.params, args.nslots, args.bitsize, args.loop, args.seed,
                  args.skip_cipher_suite, args.device)
    if args.out:
        results["params"] = args.params
        results["nslots"] = args.nslots
        results["bitsize"] = args.bitsize
        results["device"] = devinfo.name(args.device)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)


if __name__ == "__main__":
    main()
