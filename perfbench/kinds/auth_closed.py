"""Traffic kind `auth_closed`: full-width PEBA1 authentications, one client
in a closed loop.

Parameters (the traffic file):
  mix           request kinds and their weights: `genuine` (probe = template
                plus small offsets, distance drawn below the bound),
                `at_bound` (distance equal to the bound: a match),
                `over_bound` (the bound plus one: no match), `impostor` (an
                independent random probe).

The kind's own constants: `CHECK_CALLS` bootstrap calls, sampled uniformly
over the window from the seed (the first and the last call always),
compared with the reference in full; `TRACE_CALLS`, the first call and the
number of calls that the traced run profiles.

A request runs `Server.authenticate` (Function_f, then Function_g on fresh
nonces), the client's proof (decrypting y) and `Server.verify_proof`, and
ends with a synchronize.  The client encrypts the next request's template,
probe and bound between requests, outside the request's time.  A request
starts only while the time left exceeds the last request's time; the first
always runs, so every timed request is whole.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import material, port
from ..checks import Check
from ..reference import peba1
from ..reference import tfhe as ref
from ..trace import REQUEST_SPAN

CHECK_CALLS = 32
TRACE_CALLS = (200, 200)


def _pair(rng, kind: str, nslots: int, bitsize: int, bound: int):
    """(template, probe) of `kind`, distances as the circuit computes them."""
    hi = (1 << bitsize) - 1
    while True:
        t = rng.integers(0, hi + 1, nslots)
        if kind == "impostor":
            p = rng.integers(0, hi + 1, nslots)
            if peba1.distance(t, p, bitsize) > bound:
                return t, p
            continue
        target = {"genuine": int(rng.integers(0, bound)), "at_bound": bound,
                  "over_bound": bound + 1}[kind]
        p, left = t.copy(), target
        for s in rng.permutation(np.flatnonzero(t)):
            if left == 0:
                break
            d = int(rng.integers(1, math.isqrt(left) + 1))
            p[s] = t[s] + d if t[s] + d <= hi else t[s] - d
            left -= d * d
        if left == 0 and peba1.distance(t, p, bitsize) == target:
            return t, p


class Recorder(port.Observer):
    """Counts the bootstrap calls, drives the tracer, and keeps the calls to
    compare: the first, the last, and `capacity` drawn uniformly from the
    rest by reservoir sampling."""

    def __init__(self, tracer, rng, capacity: int):
        self.tracer, self.rng, self.capacity = tracer, rng, capacity
        self.calls = 0
        self.request = 0                  # the request the calls belong to
        self.first = self.last = None
        self.sample: list = []

    def before(self) -> None:
        self.tracer.before_call(self.calls)

    def after(self, kind, names, inputs, output) -> None:
        self.tracer.after_call(self.calls)
        rec = (self.request, kind, names, inputs, output)
        if self.calls == 0:
            self.first = rec
        elif self.last is not None:
            # The previous last call is now one of the rest.
            c = self.calls - 1
            if len(self.sample) < self.capacity:
                self.sample.append(self.last)
            else:
                j = int(self.rng.integers(0, c))
                if j < self.capacity:
                    self.sample[j] = self.last
        if self.calls > 0:
            self.last = rec
        self.calls += 1

    def records(self) -> list:
        return [r for r in [self.first, *self.sample, self.last] if r is not None]


class Workload:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.proto = run.config["protocol"]

    def setup(self) -> None:
        run = self.run
        s_plan, s_enc, s_nonce, s_sample = material.seeds(run.seed_of("traffic"), 4)
        self.plan_rng = np.random.default_rng(s_plan)
        kinds = sorted(self.t["mix"])
        weights = np.array([self.t["mix"][k] for k in kinds], float)
        self.kinds, self.weights = kinds, weights / weights.sum()
        self.enc_gen = material.generator(run.device, s_enc)
        self.nonce_gen = material.generator(run.device, s_nonce)
        self.recorder = Recorder(run.tracer, np.random.default_rng(s_sample),
                                 CHECK_CALLS)
        self.client, self.server = port.client_and_server(
            run.sk, run.ck, port.protocol(run.config), self.recorder)
        self.requests: list = []
        self.next_inputs = self._inputs()
        self._warm()

    def _warm(self) -> None:
        """One bootstrap call of each kind the circuits make, at a request's
        typical rows, through a backend that records nothing."""
        be = port.HarnessBackend(self.run.ck, port.Observer())
        x = self.next_inputs[1][1][:12]     # 96 of the probe's encrypted bits
        be.level([("XOR", x, x), ("AND", x, x)])
        be.gate("XNOR", x, x)
        be.MUX(x, x, x)

    def _inputs(self):
        """The next request: its plain values and the client's encryptions."""
        bitsize, nslots, bound = (self.proto[k] for k in ("bitsize", "nslots", "bound_match"))
        kind = self.kinds[int(self.plan_rng.choice(len(self.kinds), p=self.weights))]
        template, probe = _pair(self.plan_rng, kind, nslots, bitsize, bound)
        c, g = self.client, self.enc_gen
        enc = (c.encrypt_vector(g, template), c.encrypt_vector(g, probe),
               c.encrypt_word(g, bound, 3 * bitsize))
        return {"kind": kind, "template": template, "probe": probe}, enc

    def window(self, seconds: float, tracer) -> dict:
        cuda = self.run.device.type == "cuda"
        times: list = []
        start = time.perf_counter()
        while True:
            plain, (enc_t, enc_p, enc_bound) = self.next_inputs
            self.recorder.request = len(times)
            if cuda:
                torch.cuda.synchronize(self.run.device)
            t0 = time.perf_counter()
            with record_function(REQUEST_SPAN):
                res = self.server.authenticate(self.nonce_gen, enc_p, enc_t, enc_bound)
                proof = self.client.prove(res.enc_y)
                verdict = self.server.verify_proof(res, proof)
                if cuda:
                    torch.cuda.synchronize(self.run.device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            self.requests.append({**plain, "result": res, "proof": proof, "verdict": verdict})
            if start + seconds - t1 <= times[-1]:
                break
            self.next_inputs = self._inputs()
        self.times = times
        self.next_inputs = None
        return {"requests": len(times), "window_s": sum(times),
                "auth_s": sum(times) / len(times)}

    def release(self) -> None:
        self.client = self.server = None

    def readings(self) -> dict:
        return {"request_s": self.times, "bootstrap_calls": self.recorder.calls}

    # ---------------------------------------------------------------- checks

    def check(self, reference) -> "tuple[list, int, int]":
        """Each request's decision word, blinded nonce, proof and verdicts
        against the plain protocol; the sampled bootstrap calls against the
        reference bootstrap.  Returns (checks, attempted, failed)."""
        keys, bitsize, bound = self.run.keys, self.proto["bitsize"], self.proto["bound_match"]
        dev = reference.key.device
        failed = set()
        for r, req in enumerate(self.requests):
            res = req["result"]
            b = peba1.decision(req["template"], req["probe"], bound, bitsize)
            y = peba1.blinded_nonce(b, res.r0, res.r1, bitsize)
            want = peba1.verdicts(y, res.r1)
            got_b = ref.decrypt_bits(keys, res.enc_b.a.to(dev), res.enc_b.b.to(dev)).cpu().numpy()
            got_y = ref.decrypt_bits(keys, res.enc_y.a.to(dev), res.enc_y.b.to(dev)).cpu().numpy()
            ok = (np.array_equal(got_b, peba1.decision_word(b, bitsize))
                  and int((got_y << np.arange(bitsize)).sum()) == int(y)
                  and int(req["proof"]) == int(y)
                  and all(np.array_equal(req["verdict"][k], want[k]) for k in want))
            if not ok:
                failed.add(r)
        decisions = len(failed)
        mismatched = self._calls(reference, dev, failed)
        checks = [Check("decision_errors", decisions, 0),
                  Check("call_row_mismatches", mismatched, 0)]
        return checks, len(self.requests), len(failed)

    def _calls(self, reference, dev, failed: set) -> int:
        """Rows of the sampled bootstrap calls that differ from the
        reference; adds the requests they belong to to `failed`."""
        gates, muxes = [], []               # (request, inputs, program's output)
        for request, kind, names, inputs, output in self.recorder.records():
            outs = output if kind == "level" else [output]
            for name, ops, out in zip(names, inputs, outs):
                shape = out.b.shape
                flat = [(x.a.expand(shape + x.a.shape[-1:]).reshape(-1, x.a.shape[-1]).to(dev),
                         x.b.expand(shape).reshape(-1).to(dev)) for x in ops]
                got = (out.a.reshape(-1, out.a.shape[-1]).to(dev), out.b.reshape(-1).to(dev))
                if kind == "mux":
                    muxes.append((request, flat, got))
                else:
                    gates.append((request, [ref.lincomb(name, *flat)], got))
        wrong = 0
        for group, fn in ((gates, lambda x: reference.bootstrap(*x[0])),
                          (muxes, lambda x: reference.mux(*x))):
            if not group:
                continue
            operands = [(torch.cat([g[1][c][0] for g in group]),
                         torch.cat([g[1][c][1] for g in group]))
                        for c in range(len(group[0][1]))]
            want_a, want_b = fn(operands)
            got_a = torch.cat([g[2][0] for g in group])
            got_b = torch.cat([g[2][1] for g in group])
            bad = (ref.u32(got_a) != want_a).any(-1) | (ref.u32(got_b) != want_b)
            wrong += int(bad.sum())
            rows = torch.tensor([g[2][1].numel() for g in group])
            owner = torch.repeat_interleave(torch.tensor([g[0] for g in group]), rows)
            failed.update(owner[bad.cpu()].tolist())
        return wrong
