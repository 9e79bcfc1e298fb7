"""Traffic kind `gate_chain`: a serialized chain of batched gate bootstraps.

Parameters (the traffic file):
  rows          rows of every bootstrap call (B);
  gates         the two-input gates the chain draws from, one a call.

The kind's own constants, the same for every mix: `OPERAND_POOL` fresh
encryptions of random bits made in set-up, the second operand of call i
being number i mod the pool; `CHECK_ROWS` rows (all of a smaller call),
drawn from the seed, at which every call is compared; one call among the
first `FULL_CALL_WITHIN` (or the last call of a shorter window), drawn from
the seed, compared in full; `TRACE_CALLS`, the first call and the number of
calls that the traced run profiles.

Call i bootstraps gate_i(x_{i-1}, y_{i mod pool}) through the program's gate
API; its output x_i is the next call's first operand, as a circuit's levels
are.  x_{-1} is a fresh encryption of random bits.  The window keeps at most
two calls in flight, so it ends within a call of its length.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import material, port
from ..checks import Check
from ..reference import tfhe as ref

OPERAND_POOL = 16
CHECK_ROWS = 64
FULL_CALL_WITHIN = 16
TRACE_CALLS = (4, 8)


class Workload:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.rows = int(self.t["rows"])

    def setup(self) -> None:
        run, rows = self.run, self.rows
        s_bits, s_enc, s_plan = material.seeds(run.seed_of("traffic"), 3)
        rng = np.random.default_rng(s_bits)
        self.x0_bits = rng.integers(0, 2, rows)
        self.y_bits = rng.integers(0, 2, (OPERAND_POOL, rows))
        gen = material.generator(run.device, s_enc)
        enc = lambda bits: port.ciphertext(*material.encrypt_bits(  # noqa: E731
            run.lat, run.keys, gen, torch.as_tensor(bits, device=run.device)))
        self.x0 = enc(self.x0_bits)
        self.ys = [enc(b) for b in self.y_bits]
        plan = np.random.default_rng(s_plan)
        self.gate_rng = np.random.default_rng(plan.integers(1 << 62))
        self.idx = torch.as_tensor(np.sort(plan.choice(rows, min(CHECK_ROWS, rows), replace=False)),
                                   device=run.device)
        self.full_call = int(plan.integers(0, FULL_CALL_WITHIN))
        self.be = port.HarnessBackend(run.ck, port.Observer())
        for y in self.ys[:2]:                       # warm-up at the cell's shape
            self.be.gate("AND", self.x0, y)

    def window(self, seconds: float, tracer) -> dict:
        gates, be, pool = list(self.t["gates"]), self.be, len(self.ys)
        cuda = self.run.device.type == "cuda"
        names, kept, events = [], [], []
        x, prev = self.x0, None
        full = None
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if cuda and i >= 2:
                events[i - 2][1].synchronize()
            if time.perf_counter() >= deadline:
                break
            name = gates[int(self.gate_rng.integers(len(gates)))]
            tracer.before_call(i)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) \
                if cuda else (None, None)
            if cuda:
                ev[0].record()
            prev, x = x, be.gate(name, x, self.ys[i % pool])
            if cuda:
                ev[1].record()
            tracer.after_call(i)
            events.append(ev)
            names.append(name)
            kept.append((x.a.index_select(0, self.idx), x.b.index_select(0, self.idx)))
            if i == self.full_call:
                full = (i, prev, x)
            i += 1
        if cuda:
            torch.cuda.synchronize(self.run.device)
        t1 = time.perf_counter()
        self.names, self.kept = names, kept
        self.full = full if full is not None else (i - 1, prev, x)
        call_ms = [s.elapsed_time(e) for s, e in events] if cuda else []
        self.call_ms = call_ms
        out = {"calls": i, "window_s": t1 - t0,
               "bootstraps_per_s": i * self.rows / (t1 - t0)}
        if call_ms:
            out["gate_call_p90_ms"] = float(np.percentile(call_ms, 90))
            # Where the window's time went, for the log: a stall inside a
            # call shows in the largest call, one between calls in the sum.
            out["call_ms_max"], out["call_ms_sum"] = max(call_ms), sum(call_ms)
        return out

    def release(self) -> None:
        """Drop what only the program needs, keeping the outputs to judge."""
        self.be = None

    def readings(self) -> dict:
        return {"call_ms": self.call_ms, "rows": self.rows,
                "bootstrap_calls": len(self.names)}

    # ---------------------------------------------------------------- checks

    def _plain_chain(self) -> np.ndarray:
        """The bits every call should decrypt to: (calls, rows)."""
        bits, out = self.x0_bits, []
        for i, name in enumerate(self.names):
            bits = ref.GATES[name][3](bits, self.y_bits[i % len(self.ys)])
            out.append(bits)
        return np.stack(out)

    def check(self, reference) -> "tuple[list, int, int]":
        """Every call at the sampled rows and one call in full against the
        reference (`checks.Reference`); every compared row's
        decrypted bit against the plain chain.  Returns (checks, attempted,
        failed calls)."""
        keys, device = reference.keys, reference.key.device
        idx = self.idx.to(device)
        ys = [(y.a.to(device), y.b.to(device)) for y in self.ys]
        kept = [(a.to(device), b.to(device)) for a, b in self.kept]
        calls, R = len(self.names), idx.numel()
        # Inputs of each call at the sampled rows: the previous call's output
        # there (the chain's fresh start for call 0) and the pool operand.
        prev_a = torch.stack([self.x0.a.to(device)[idx]] + [a for a, _ in kept[:-1]])
        prev_b = torch.stack([self.x0.b.to(device)[idx]] + [b for _, b in kept[:-1]])
        ya = torch.stack([ys[i % len(ys)][0][idx] for i in range(calls)])
        yb = torch.stack([ys[i % len(ys)][1][idx] for i in range(calls)])
        pre_a, pre_b = self._lincomb(prev_a, prev_b, ya, yb)
        j, x_in, x_out = self.full
        fa, fb = self._lincomb(x_in.a.to(device)[None], x_in.b.to(device)[None],
                               ys[j % len(ys)][0][None], ys[j % len(ys)][1][None], [self.names[j]])
        want_a, want_b = reference.bootstrap(torch.cat([pre_a.reshape(calls * R, -1), fa[0]]),
                                   torch.cat([pre_b.reshape(-1), fb[0]]))
        got_a = torch.cat([torch.stack([a for a, _ in kept]).reshape(calls * R, -1),
                           x_out.a.to(device)])
        got_b = torch.cat([torch.stack([b for _, b in kept]).reshape(-1), x_out.b.to(device)])
        wrong = ((ref.u32(got_a) != want_a).any(-1) | (ref.u32(got_b) != want_b))
        plain = self._plain_chain()
        want_bits = torch.as_tensor(np.concatenate([plain[:, idx.cpu().numpy()].reshape(-1),
                                                    plain[j]]), device=device)
        bit_wrong = ref.decrypt_bits(keys, got_a, got_b) != want_bits
        bad = wrong | bit_wrong
        per_call = bad[:calls * R].view(calls, R).any(1)
        per_call[j] |= bad[calls * R:].any()
        checks = [Check("row_mismatches", int(wrong.sum()), 0),
                  Check("bit_errors", int(bit_wrong.sum()), 0)]
        return checks, calls, int(per_call.sum())

    def _lincomb(self, a, b, ya, yb, names=None):
        """Each call's gate combination of its two operands, (calls, R, ...)."""
        names = self.names if names is None else names
        w = torch.tensor([ref.GATES[n][:3] for n in names], dtype=torch.int64, device=a.device)
        wa, wb, off = (w[:, c].view(-1, 1) for c in range(3))
        pa = (wa[..., None] * ref.u32(a) + wb[..., None] * ref.u32(ya)) & ref.MASK32
        pb = (wa * ref.u32(b) + wb * ref.u32(yb) + off) & ref.MASK32
        return pa, pb
