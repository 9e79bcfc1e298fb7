"""Traffic kind `identify_closed`: 1:N face identifications by encrypted
tournament argmin, one client in a closed loop.

Parameters (the traffic file):
  templates     the gallery a request searches: as many encrypted templates
                as the configuration's `gallery.templates`;
  mix           request kinds and their weights: `genuine` (the probe within
                the bound of one template, its index drawn uniformly, every
                other template over the bound), `tie` (two templates, their
                indices drawn, at the same least distance, within the bound;
                the lower index must win), `impostor` (every template over
                the bound).

Distances are the identification's (`reference.identify.identify_distances`:
the sign bit forced on the probe's zero slots).  Half the genuine requests
put the near template's offsets under the probe's zero slots, where PEBA1's
1:1 order (`one_to_one_distances`) disagrees; the window's outcome, logged,
counts the requests on which the two orders give another answer
(`orders_differ`).

The kind's own constants: `CHECK_CALLS` bootstrap calls, sampled uniformly
over the window from the seed (the first and the last call always), and of
each `CHECK_ROWS` rows (all of a smaller call) evenly spaced from an offset
drawn from the seed, compared with the reference; `TRACE_CALLS`, the first
call and the number of calls that the traced run profiles.

A request runs `Server.identify_argmin` on its encrypted gallery and probe,
then the client's decryption of the least distance and of the index, and
ends with a synchronize.  Each request has a gallery and a probe of its own,
drawn from the seed; the client encrypts the next request's between
requests, outside the request's time.  A request starts only while the time
left exceeds the last request's time; the first always runs, so every timed
request is whole.  On a card a CUDA event pair times each bootstrap call.
Set-up warms one bootstrap call of each kind, gate list and rows that a
request makes, found by running `Server.identify_argmin` on shapes alone.
The window resets the program's tournament counter
(`circuits.argmin_counts`) and its backend's call counter at its start.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from peba1_tpu_torch import circuits, lwe
from peba1_tpu_torch.backends import CountingBackend
from peba1_tpu_torch.protocol import Server

from .. import material, port
from . import auth_closed
from ..checks import Check
from ..reference import identify
from ..reference import tfhe as ref
from ..trace import REQUEST_SPAN

CHECK_CALLS = 64
CHECK_ROWS = 256
# Calls 82-141 of a request at the configuration's sizes: 20 gates of 512
# rows and 20 levels each of 1,024 and 2,048 rows (a replay's count).
TRACE_CALLS = (82, 60)


def _near(rng, probe, target: int, bitsize: int, across: bool = False):
    """A template at identification distance `target` from the probe, or
    None where the draw misses.  Offsets d go on the probe's nonzero slots,
    each template slot under a zero probe slot 0 (it adds 0); `across` puts
    them first under the probe's zero slots, as 2^bitsize - d, where PEBA1's
    1:1 order (`identify.one_to_one_distances`) would see (2^bitsize - d)^2."""
    hi = (1 << bitsize) - 1
    t, left = probe.copy(), target
    slots = rng.permutation(np.flatnonzero(probe))
    if across:
        slots = np.concatenate([rng.permutation(np.flatnonzero(probe == 0)), slots])
    for s in slots:
        if left == 0:
            break
        d = int(rng.integers(1, math.isqrt(left) + 1))
        if probe[s] == 0:
            t[s] = hi + 1 - d
        else:
            t[s] = probe[s] + d if probe[s] + d <= hi else probe[s] - d
        left -= d * d
    return t if left == 0 else None


def gallery(rng, kind: str, templates: int, nslots: int, bitsize: int, bound: int,
            tries: int = 64):
    """(templates (N, nslots), probe (nslots,)) of a request of `kind`.  Half
    the genuine requests cross: the probe has a zero slot (one drawn slot
    set to 0 where it has none) and the near template's offsets go first
    under its zero slots (`_near`), where the identification's order and
    PEBA1's 1:1 order disagree.  A probe and distance that `tries` draws of
    a template cannot meet (at toy sizes: too few nonzero slots) are drawn
    anew."""
    hi = (1 << bitsize) - 1
    while True:
        probe = rng.integers(0, hi + 1, nslots)
        across = kind == "genuine" and bool(rng.random() < 0.5)
        if across and (probe != 0).all():
            probe[int(rng.integers(0, nslots))] = 0
        near = {"genuine": [int(rng.integers(0, templates))],
                "tie": sorted(int(i) for i in rng.choice(templates, 2, replace=False)),
                "impostor": []}[kind]
        target = int(rng.integers(1 if kind == "tie" or across else 0, bound + 1))
        out = np.empty((templates, nslots), np.int64)
        for i in range(templates):
            for _ in range(tries):
                if i in near:
                    t = _near(rng, probe, target, bitsize, across)
                    ok = (t is not None
                          and not any(np.array_equal(t, out[j]) for j in near if j < i)
                          and identify.identify_distances(t[None], probe, bitsize)[0] == target)
                else:
                    t = rng.integers(0, hi + 1, nslots)
                    ok = identify.identify_distances(t[None], probe, bitsize)[0] > bound
                if ok:
                    out[i] = t
                    break
            else:
                break
        else:
            return out, probe


def orders_differ(templates, probe, bitsize: int) -> bool:
    """Whether PEBA1's 1:1 order gives another (least distance, index)."""
    d = identify.one_to_one_distances(templates, probe, bitsize)
    least = int(d.min())
    return (least, int(np.flatnonzero(d == least)[0])) != identify.identify_argmin(
        templates, probe, bitsize)


class Shapes(CountingBackend):
    """A cipher backend on shapes alone: each result an empty ciphertext of
    `dim` on the meta device.  The program's `CountingBackend` counts each
    bootstrap call, on meta tensors of the operands' shapes; `calls` lists
    each call's (kind, gate names, bootstraps)."""

    is_cipher = True

    def __init__(self, dim: int):
        super().__init__("meta")
        self.dim = dim
        self.calls: list = []

    def ct(self, shape):
        shape = tuple(shape)
        return port.ciphertext(torch.empty(shape + (self.dim,), dtype=torch.int32, device="meta"),
                               torch.empty(shape, dtype=torch.int32, device="meta"))

    def _t(self, x):
        if isinstance(x, lwe.Lwe):
            return torch.empty(x.shape, dtype=torch.int32, device="meta")
        return super()._t(x)

    def _call(self, kind, names, count):
        before = self.bootstraps
        out = count()
        self.calls.append((kind, names, self.bootstraps - before))
        return [self.ct(o.shape) for o in out] if kind == "level" else self.ct(out.shape)

    def gate(self, name, a, b):
        return self._call("gate", [name], lambda: CountingBackend.gate(self, name, a, b))

    def MUX(self, a, b, c):
        return self._call("mux", ["MUX"], lambda: CountingBackend.MUX(self, a, b, c))

    def level(self, ops):
        return self._call("level", [name for name, _, _ in ops],
                          lambda: CountingBackend.level(self, ops))

    def NOT(self, a):
        return -a

    def CONSTANT(self, value, shape=()):
        return self.ct(shape)

    def stack(self, xs, axis=0):
        return lwe.stack(xs, axis=axis)

    def concat(self, xs, axis=0):
        return lwe.concatenate(xs, axis=axis)


def replay_calls(proto, templates: int, dim: int) -> "list[tuple[str, list, int]]":
    """(kind, gate names, bootstraps) of each bootstrap call that one
    `Server.identify_argmin` makes at these sizes, in order: the program's
    own method on the `Shapes` backend."""
    server = Server(None, proto)
    server.be = Shapes(dim)
    server.identify_argmin(server.be.ct((proto.nslots, proto.bitsize)),
                           server.be.ct((templates, proto.nslots, proto.bitsize)))
    return server.be.calls


class Recorder(port.Observer):
    """Counts the bootstrap calls, drives the tracer, times each call with a
    CUDA event pair on a card, and keeps rows of the calls to compare: the
    first, the last, and `capacity` drawn uniformly from the rest by
    reservoir sampling, each cut to `rows` rows when it is kept."""

    def __init__(self, tracer, rng, capacity: int, rows: int, cuda: bool):
        self.tracer, self.rng, self.capacity, self.rows = tracer, rng, capacity, rows
        self.cuda = cuda
        self.calls = 0
        self.request = 0                  # the request the calls belong to
        self.events: list = []            # [start, end] a call
        self.first = self.last = None
        self.sample: list = []

    def before(self) -> None:
        self.tracer.before_call(self.calls)
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events.append([start, None])

    def after(self, kind, names, inputs, output) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events[-1][1] = end
        self.tracer.after_call(self.calls)
        rec = (self.request, kind, names, inputs, output)
        if self.calls == 0:
            self.first = self.cut(rec)
        elif self.last is not None:
            # The previous last call is now one of the rest.
            c = self.calls - 1
            if len(self.sample) < self.capacity:
                self.sample.append(self.cut(self.last))
            else:
                j = int(self.rng.integers(0, c))
                if j < self.capacity:
                    self.sample[j] = self.cut(self.last)
        self.last = rec if self.calls > 0 else None
        self.calls += 1

    def cut(self, rec):
        """The call's record with, of each of its gates (a level's), only
        the rows kept, copied off the call's tensors as flat ciphertexts."""
        request, kind, names, inputs, output = rec
        outs = output if kind == "level" else [output]
        take = math.ceil(self.rows / len(outs))
        kept_inputs, kept_outs = [], []
        for operands, out in zip(inputs, outs):
            shape, n = tuple(out.b.shape), out.a.shape[-1]
            count = math.prod(shape)
            k = min(take, count)
            step = count // k
            start = int(self.rng.integers(0, count - step * (k - 1)))
            rows = slice(start, start + step * (k - 1) + 1, step)
            kept_inputs.append(tuple(
                port.ciphertext(x.a.expand(shape + (n,)).reshape(-1, n)[rows].clone(),
                                x.b.expand(shape).reshape(-1)[rows].clone()) for x in operands))
            kept_outs.append(port.ciphertext(out.a.reshape(-1, n)[rows].clone(),
                                             out.b.reshape(-1)[rows].clone()))
        return (request, kind, names, kept_inputs,
                kept_outs if kind == "level" else kept_outs[0])

    def records(self) -> list:
        last = [self.cut(self.last)] if self.last is not None else []
        return [r for r in [self.first, *self.sample] if r is not None] + last

    def call_ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.events]


class Workload:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.proto = run.config["protocol"]
        self.templates = int(self.t["templates"])
        here = run.config.get("gallery", {}).get("templates", self.templates)
        if here != self.templates:
            raise ValueError(f"traffic of {self.templates} templates on a configuration "
                             f"that holds {here}")

    def setup(self) -> None:
        run = self.run
        s_plan, s_enc, s_sample = material.seeds(run.seed_of("traffic"), 3)
        self.plan_rng = np.random.default_rng(s_plan)
        kinds = sorted(self.t["mix"])
        weights = np.array([self.t["mix"][k] for k in kinds], float)
        self.kinds, self.weights = kinds, weights / weights.sum()
        self.enc_gen = material.generator(run.device, s_enc)
        self.cuda = run.device.type == "cuda"
        self.recorder = Recorder(run.tracer, np.random.default_rng(s_sample),
                                 CHECK_CALLS, CHECK_ROWS, self.cuda)
        self.client, self.server = port.client_and_server(
            run.sk, run.ck, port.protocol(run.config), self.recorder)
        self.requests: list = []
        self.next_inputs = self._inputs()
        self._warm()

    def _warm(self) -> None:
        """One bootstrap call of each kind, gate list and rows that a request
        makes, on rows of the encrypted gallery and probe, through a backend
        that records nothing."""
        be = port.HarnessBackend(self.run.ck, port.Observer())
        enc_t, enc_p = self.next_inputs[1]
        n = enc_t.a.shape[-1]
        a = torch.cat([enc_t.a.reshape(-1, n), enc_p.a.reshape(-1, n)])
        b = torch.cat([enc_t.b.reshape(-1), enc_p.b.reshape(-1)])
        seen = set()
        for kind, names, bootstraps in replay_calls(port.protocol(self.run.config),
                                                    self.templates, n):
            if (kind, tuple(names), bootstraps) in seen:
                continue
            seen.add((kind, tuple(names), bootstraps))
            per = bootstraps // (2 if kind == "mux" else len(names))
            idx = torch.arange(per, device=a.device) % a.shape[0]
            x = port.ciphertext(a[idx], b[idx])
            if kind == "mux":
                be.MUX(x, x, x)
            elif kind == "gate":
                be.gate(names[0], x, x)
            else:
                be.level([(name, x, x) for name in names])

    def _inputs(self):
        """The next request: its plain values and the client's encryptions."""
        bitsize, nslots, bound = (self.proto[k] for k in ("bitsize", "nslots", "bound_match"))
        kind = self.kinds[int(self.plan_rng.choice(len(self.kinds), p=self.weights))]
        templates, probe = gallery(self.plan_rng, kind, self.templates, nslots, bitsize, bound)
        c, g = self.client, self.enc_gen
        return ({"kind": kind, "templates": templates, "probe": probe},
                (c.encrypt_vector(g, templates), c.encrypt_vector(g, probe)))

    def window(self, seconds: float, tracer) -> dict:
        # A program older than the tournament's counter runs the cell all
        # the same; `identify.argmin_bootstraps` then reads nothing.
        if hasattr(circuits, "reset_argmin_counts"):
            circuits.reset_argmin_counts()
        self.server.be.launches = 0
        times: list = []
        start = time.perf_counter()
        while True:
            plain, (enc_t, enc_p) = self.next_inputs
            self.recorder.request = len(times)
            if self.cuda:
                torch.cuda.synchronize(self.run.device)
            t0 = time.perf_counter()
            with record_function(REQUEST_SPAN):
                enc_d, enc_i = self.server.identify_argmin(enc_p, enc_t)
                least = int(self.client.decrypt_word(enc_d))
                index = int(self.client.decrypt_word(enc_i))
                if self.cuda:
                    torch.cuda.synchronize(self.run.device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            self.requests.append({**plain, "enc_d": enc_d, "enc_i": enc_i,
                                  "least": least, "index": index})
            if start + seconds - t1 <= times[-1]:
                break
            self.next_inputs = self._inputs()
        self.times = times
        self.calls = self.server.be.launches
        self.call_ms = self.recorder.call_ms() if self.cuda else []
        self.next_inputs = None
        bitsize = self.proto["bitsize"]
        return {"requests": len(times), "window_s": sum(times),
                "auth_s": sum(times) / len(times),
                "kinds": [r["kind"] for r in self.requests],
                "orders_differ": sum(orders_differ(r["templates"], r["probe"], bitsize)
                                     for r in self.requests)}

    def release(self) -> None:
        self.client = self.server = None

    def readings(self) -> dict:
        return {"request_s": self.times, "bootstrap_calls": self.calls,
                "call_ms": self.call_ms}

    # ---------------------------------------------------------------- checks

    def check(self, reference) -> "tuple[list, int, int]":
        """Each request's decrypted least distance and index (by the
        reference's decryption and by the client's) against the plain 1:N
        argmin; the sampled rows of the sampled bootstrap calls against the
        reference bootstrap.  Returns (checks, attempted, failed)."""
        keys, bitsize = self.run.keys, self.proto["bitsize"]
        dev = reference.key.device
        failed = set()

        def value(ct):
            bits = ref.decrypt_bits(keys, ct.a.to(dev), ct.b.to(dev)).cpu().numpy()
            return int((bits << np.arange(bits.shape[-1])).sum())

        for r, req in enumerate(self.requests):
            want = identify.identify_argmin(req["templates"], req["probe"], bitsize)
            got = (value(req["enc_d"]), value(req["enc_i"]))
            if got != want or (req["least"], req["index"]) != want:
                failed.add(r)
        wrong_answers = len(failed)
        mismatched = self._calls(reference, dev, failed)
        checks = [Check("identify_errors", wrong_answers, 0),
                  Check("call_row_mismatches", mismatched, 0)]
        return checks, len(self.requests), len(failed)

    # The sampled rows against the reference bootstrap, as the auth kind
    # compares its sampled calls.
    _calls = auth_closed.Workload._calls
