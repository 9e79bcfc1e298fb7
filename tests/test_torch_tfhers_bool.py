"""tfhe-rs's boolean default lattice (`tfhers_bool_gen`: k=2, N=512, l=3,
Bg=2^6, keyswitch 4 x 2^3) against the benchmark's plain reference.

At its CPU twin `toy_tfhers_bool` (the same k, gadget, keyswitch, limbs and
kernel flags at n=32, N=128, noise-free), on seeded raw keys from
`perfbench.material.make_keys` loaded through `perfbench.port.load_keys`:
bootstraps, a gate chain over all ten gates and every bootstrap call of a
small authentication are bit-exact against `perfbench.reference.tfhe`; the
keyswitch digits recompose to the 12-bit rounding; the tile plan's split
divides G=9; and a traced kernel-1 call opens `peba1.accumulator` inside
`peba1.rotation`.  Imports no JAX.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from peba1_tpu_torch import lwe
from peba1_tpu_torch.ops import bootstrap as bs
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.params import PRESETS, TFHERS_BOOL_GEN, TOY_TFHERS_BOOL, ProtocolParams
from peba1_tpu_torch.utils import logging as plog
from perfbench import material, port
from perfbench.checks import Reference
from perfbench.reference import peba1
from perfbench.reference import tfhe as ref

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores.
torch.set_num_threads(1)

P = TOY_TFHERS_BOOL
CONFIG = os.path.join(os.path.dirname(__file__), "..", "perfbench", "configs",
                      "peba1_tfhersbool.json")
# The driver's protocol at 4 slots of 4 bits: sums on 3*bitsize - 1 bits.
PROTO = ProtocolParams(nslots=4, bitsize=4, max_bitsize=12, mul_width=11, bound_match=8)


def lattice(p) -> ref.Lattice:
    return ref.Lattice.of(dataclasses.asdict(p))


@pytest.fixture(scope="module")
def keyset():
    """(lattice, raw keys, secret key, cloud key, reference) at the toy twin."""
    lat = lattice(P)
    raw = material.make_keys(lat, material.generator("cpu", 1801))
    sk, ck_ = port.load_keys(P, raw, torch.device("cpu"))
    return lat, raw, sk, ck_, Reference(lat, raw)


def encrypt(lat, raw, seed, bits):
    a, b = material.encrypt_bits(lat, raw, material.generator("cpu", seed),
                                 torch.as_tensor(bits))
    return lwe.Lwe(a, b)


def assert_same(got: lwe.Lwe, want) -> None:
    assert torch.equal(ref.u32(got.a), want[0])
    assert torch.equal(ref.u32(got.b), want[1])


def test_the_presets_are_the_published_lattice_and_its_twin():
    p = PRESETS["tfhers_bool_gen"]
    assert p is TFHERS_BOOL_GEN and PRESETS["toy_tfhers_bool"] is P
    assert (p.n, p.k, p.N, p.l, p.bgbit, p.ks_t, p.ks_basebit) == (722, 2, 512, 3, 6, 4, 3)
    assert (p.lwe_stdev, p.tlwe_stdev) == (1.3071021089943935e-05, 4.990272175010415e-08)
    assert p.limb_plan == (4, 4, 4)
    assert bs.selected_kernel(p) == bs.selected_kernel(P) == "cmux_step_gen"
    twin = dataclasses.replace(p, n=P.n, N=P.N, lwe_stdev=0.0, tlwe_stdev=0.0)
    assert twin == P


def test_the_benchmark_configuration_runs_the_preset():
    """The cell's configuration file gives the program these parameters."""
    with open(CONFIG) as f:
        config = json.load(f)
    assert port.params(config) == TFHERS_BOOL_GEN
    assert config["reduced"] == []


def test_bootstrap_is_bit_exact(keyset):
    lat, raw, _, ck_, reference = keyset
    bits = np.random.default_rng(2).integers(0, 2, 64)
    ct = encrypt(lat, raw, 3, bits)
    got = bs.bootstrap(ck_, ct, ref.MU_1_8)
    want = reference.bootstrap(ct.a, ct.b)
    assert_same(got, want)
    assert torch.equal(ref.decrypt_bits(raw, *want), torch.as_tensor(bits))


def test_a_gate_chain_over_every_gate_is_bit_exact(keyset):
    """16 calls, call i gate_i(x_{i-1}, y_i) with the ten gates in turn:
    every call's output equals the reference's on the same inputs, and
    decrypts to the plain chain."""
    lat, raw, _, ck_, reference = keyset
    names = (list(ref.GATES) * 2)[:16]
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 32)
    x = encrypt(lat, raw, 5, bits)
    be = port.HarnessBackend(ck_, port.Observer())
    for i, name in enumerate(names):
        y_bits = rng.integers(0, 2, 32)
        y = encrypt(lat, raw, 100 + i, y_bits)
        want = reference.bootstrap(*ref.lincomb(name, (x.a, x.b), (y.a, y.b)))
        x = be.gate(name, x, y)
        assert_same(x, want)
        bits = ref.GATES[name][3](bits, y_bits)
        assert torch.equal(ref.decrypt_bits(raw, *want), torch.as_tensor(bits)), name


@pytest.mark.parametrize("seed", [6, 7])
def test_keyswitch_digits_recompose_to_the_12_bit_rounding(seed):
    p = TFHERS_BOOL_GEN
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (8, p.k * p.N), dtype=np.int64)
    x[0, :6] = [-2**31, 2**31 - 1, 0, -1, 2**19, 2**19 - 1]   # the rounding's edges
    a = torch.as_tensor(x.astype(np.int32))
    d = bs.keyswitch_digits(p, a)
    assert d.shape == (8, p.k * p.N * 4) and d.dtype == torch.int8
    assert int(d.min()) >= 0 and int(d.max()) < 8
    shifts = torch.tensor([29, 26, 23, 20])
    back = (d.view(8, -1, 4).to(torch.int64) << shifts).sum(-1) & ref.MASK32
    rounded = (ref.u32(a) + (1 << 19)) & (ref.MASK32 ^ ((1 << 20) - 1))
    assert torch.equal(back, rounded)


class _Calls(port.Observer):
    """Keeps every bootstrap call the backend makes."""

    def __init__(self):
        self.records = []

    def after(self, kind, names, inputs, output) -> None:
        self.records.append((kind, names, inputs, output))


def _call_rows(kind, names, inputs, output):
    """Each gate of a call as flat rows: (kind, name, operand pairs, output pair)."""
    outs = output if kind == "level" else [output]
    for name, ops, out in zip(names, inputs, outs):
        shape = out.b.shape
        flat = [(x.a.expand(shape + x.a.shape[-1:]).reshape(-1, x.a.shape[-1]),
                 x.b.expand(shape).reshape(-1)) for x in ops]
        yield kind, name, flat, (out.a.reshape(-1, out.a.shape[-1]), out.b.reshape(-1))


@pytest.fixture(scope="module")
def authentication(keyset):
    """One batched authentication of a match and a non-match request on the
    harness's backend, every bootstrap call kept."""
    _, _, sk, ck_, _ = keyset
    calls = _Calls()
    client, server = port.client_and_server(sk, ck_, PROTO, calls)
    gen = torch.Generator().manual_seed(8)
    template = np.array([[3, 9, 12, 5], [3, 9, 12, 5]])
    probe = np.array([[4, 8, 12, 6], [9, 1, 2, 15]])        # ED 3 <= 8, ED 300 > 8
    rec = client.enroll(gen, template)
    res = server.authenticate(gen, client.encrypt_vector(gen, probe), rec.template_ct,
                              client.encrypt_word(gen, [8, 8], 3 * PROTO.bitsize))
    proof = client.prove(res.enc_y)
    return template, probe, res, proof, server.verify_proof(res, proof), calls.records


def test_an_authentication_decides_as_the_plaintext(authentication, keyset):
    _, raw, _, _, _ = keyset
    template, probe, res, proof, verdict, _ = authentication
    b = peba1.decision(template, probe, PROTO.bound_match, PROTO.bitsize)
    assert b.tolist() == [0, 1]
    y = peba1.blinded_nonce(b, res.r0, res.r1, PROTO.bitsize)
    got_b = ref.decrypt_bits(raw, res.enc_b.a, res.enc_b.b).numpy()
    assert np.array_equal(got_b, peba1.decision_word(b, PROTO.bitsize))
    assert np.array_equal(proof, y)
    want = peba1.verdicts(y, res.r1)
    assert all(np.array_equal(verdict[k], want[k]) for k in want)


def test_every_call_of_the_authentication_is_bit_exact(authentication, keyset):
    """Every row of every bootstrap call; the gates (lone or in a level) as
    one reference batch, the MUXes as another."""
    reference = keyset[4]
    records = authentication[5]
    assert len(records) > 50
    rows = [row for r in records for row in _call_rows(*r)]
    for kinds, fn in (({"gate", "level"}, lambda ops: reference.bootstrap(*ops[0])),
                      ({"mux"}, lambda ops: reference.mux(*ops))):
        group = [(ref.lincomb(name, *flat),) if kind != "mux" else flat
                 for kind, name, flat, _ in rows if kind in kinds]
        assert group, kinds
        ops = [(torch.cat([g[c][0] for g in group]), torch.cat([g[c][1] for g in group]))
               for c in range(len(group[0]))]
        want_a, want_b = fn(ops)
        got = [got for kind, _, _, got in rows if kind in kinds]
        assert torch.equal(ref.u32(torch.cat([g[0] for g in got])), want_a)
        assert torch.equal(ref.u32(torch.cat([g[1] for g in got])), want_b)


@pytest.mark.parametrize("B,split", [(92, 9), (8192, 1)])
def test_the_tile_plan_splits_g9_by_a_divisor(B, split):
    """G = 9 digit polynomials: round-robin would take every polynomial as
    its own split at 92 rows (24 tiles) and none at 8,192 rows (1,536
    tiles) on 132 SMs; kernel 1 walks by stage and is unsplit at both."""
    plan = ck.tile_plan(B, TFHERS_BOOL_GEN, "cmux_step_gen", 132)
    assert plan.blocks == 9 and plan.split == 1
    assert ck.round_robin_split(plan.tiles, plan.blocks, 132) == split
    assert plan.tiles == -(-B // 128) * 3 * 8


def test_a_kernel_1_call_opens_the_accumulator_inside_the_rotation(keyset):
    lat, raw, _, ck_, _ = keyset
    ct = encrypt(lat, raw, 9, [0, 1, 1, 0])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        bs.bootstrap(ck_, ct, ref.MU_1_8)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith(plog.SPAN_PREFIX)), key=lambda s: (s[1], -s[2]))
    names = [s[0] for s in spans]
    rotation = spans[names.index("peba1.rotation")]
    inside = [n for n, s, e in spans if rotation[1] <= s and e <= rotation[2] and
              n != "peba1.rotation"]
    assert inside[:2] == ["peba1.accumulator", "peba1.kernel.cmux_step_gen"]
    assert names.count("peba1.accumulator") == 1

