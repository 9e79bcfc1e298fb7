"""1:N identification by encrypted tournament argmin (`Server.identify_argmin`).

* The port's cipher path on a toy noise-free lattice (n=16, N=64: the
  modswitch's rounding, the only noise, stays about 7 sigma inside the 1/16
  margin), 2 slots of 3 bits, at N = 1-5 templates (byes at 3 and 5, ties
  at the lowest and at the highest pair), decrypted and held to the
  benchmark's plain reference, `perfbench.reference.identify.identify_argmin`;
* the benchmark kind's `genuine`, `tie` and `impostor` galleries have the
  distances they claim, and half the genuine ones put the near template's
  offsets under the probe's zero slots, where PEBA1's 1:1 order disagrees;
* the tournament's counter (`circuits.argmin_counts`) equals
  `CountingBackend`'s calls and bootstraps, resets, and stays still on the
  1:1 circuit;
* both spans of `identify_argmin` open under a CPU profiler.
"""

import dataclasses

import numpy as np
import pytest
import torch

from peba1_tpu_torch import circuits as cc
from peba1_tpu_torch import keys
from peba1_tpu_torch.backends import CountingBackend
from peba1_tpu_torch.params import TOY, ProtocolParams
from peba1_tpu_torch.protocol import ClientDevice, Server
from peba1_tpu_torch.utils.bits import int_to_bits
from perfbench.kinds import identify_closed
from perfbench.reference import identify

torch.set_num_threads(1)

PARAMS = dataclasses.replace(TOY, n=16, N=64)
PROTO = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)
FULL = ProtocolParams()
# N -> (templates, probe).  A zero probe slot meets the circuit's forced sign
# bit (the reference's identification distance has it too).
GALLERIES = {
    1: ([[5, 2]], [4, 0]),
    2: ([[3, 1], [1, 3]], [2, 2]),                        # tie at the only pair
    3: ([[6, 0], [0, 6], [4, 4]], [0, 0]),                # tie at the lowest pair, a bye
    4: ([[7, 7], [1, 6], [3, 5], [5, 3]], [4, 4]),        # tie at the highest pair
    5: ([[7, 0], [0, 7], [6, 6], [3, 1], [1, 3]], [2, 2]),  # at the highest pair, a bye
}


@pytest.fixture(scope="module")
def parties():
    gen = torch.Generator().manual_seed(24)
    sk, ck = keys.keygen(gen, PARAMS, "cpu")
    return gen, ClientDevice(7, sk, ck, PROTO), Server(ck, PROTO)


def test_the_galleries_hold_their_ties():
    for n, (t, p) in GALLERIES.items():
        d = identify.identify_distances(t, p, 3)
        assert len(d) == n
        if n > 1:
            assert (d == d.min()).sum() == 2, (n, d)
    assert identify.identify_argmin(*GALLERIES[3], 3)[1] == 0
    assert identify.identify_argmin(*GALLERIES[4], 3)[1] == 2
    assert identify.identify_argmin(*GALLERIES[5], 3)[1] == 3


@pytest.mark.parametrize("n", sorted(GALLERIES))
def test_identify_argmin_against_the_plain_reference(parties, n):
    gen, client, server = parties
    templates, probe = GALLERIES[n]
    enc_d, enc_i = server.identify_argmin(client.encrypt_vector(gen, np.array(probe)),
                                          client.encrypt_vector(gen, np.array(templates)))
    assert enc_d.shape == (PROTO.max_bitsize,)
    assert enc_i.shape == (max(1, (n - 1).bit_length()),)
    got = (int(client.decrypt_word(enc_d)), int(client.decrypt_word(enc_i)))
    assert got == identify.identify_argmin(templates, probe, PROTO.bitsize)


@pytest.mark.parametrize("proto", [PROTO, FULL], ids=["toy", "full"])
@pytest.mark.parametrize("kind", ["genuine", "tie", "impostor"])
def test_the_kinds_galleries_have_the_distances_they_claim(kind, proto):
    rng = np.random.default_rng(2**33 + 5)
    bound = proto.bound_match
    for _ in range(20 if proto is PROTO else 3):
        t, p = identify_closed.gallery(rng, kind, 4, proto.nslots, proto.bitsize, bound)
        assert t.shape == (4, proto.nslots) and p.shape == (proto.nslots,)
        assert 0 <= t.min() and t.max() < 1 << proto.bitsize
        d = identify.identify_distances(t, p, proto.bitsize)
        least = d.min()
        if kind == "impostor":
            assert least > bound
            continue
        assert least <= bound
        winners = np.flatnonzero(d == least)
        assert len(winners) == (2 if kind == "tie" else 1)
        assert (d[d != least] > bound).all()
        if kind == "tie":
            assert not np.array_equal(t[winners[0]], t[winners[1]])


@pytest.mark.parametrize("proto", [PROTO, FULL], ids=["toy", "full"])
def test_half_the_genuine_galleries_cross_the_probes_zero_slots(proto):
    """Where the near template has nonzero slots under the probe's zero
    slots, PEBA1's 1:1 order sees it over the bound: the requests on which
    the identification's order and the 1:1 order give other answers."""
    rng = np.random.default_rng(2**33 + 11)
    draws = 24 if proto is PROTO else 8
    crossed = 0
    for _ in range(draws):
        t, p = identify_closed.gallery(rng, "genuine", 4, proto.nslots, proto.bitsize,
                                       proto.bound_match)
        winner = int(np.argmin(identify.identify_distances(t, p, proto.bitsize)))
        across = bool(((p == 0) & (t[winner] != 0)).any())
        one_to_one = identify.one_to_one_distances(t, p, proto.bitsize)[winner]
        if across and (t[winner][p == 0] != 1 << (proto.bitsize - 1)).any():
            assert one_to_one > proto.bound_match
            assert identify_closed.orders_differ(t, p, proto.bitsize)
        crossed += across
    assert 0 < crossed < draws


def _tournament_counts(proto, device):
    """(CountingBackend's calls and bootstraps of the tournament, the
    counter's) over one identify_argmin of 4 templates."""
    be = CountingBackend(device)
    rng = np.random.default_rng(3)
    hi = 1 << proto.bitsize
    t = int_to_bits(rng.integers(0, hi, (4, proto.nslots)), proto.bitsize, device)
    p = int_to_bits(rng.integers(0, hi, proto.nslots), proto.bitsize, device)
    d = cc.euclidean(be, p.expand(t.shape), t, proto.bitsize, proto.max_bitsize)
    calls, boots = be.launches, be.bootstraps
    cc.reset_argmin_counts()
    cc.argmin_tree(be, d, cc.const_word(be, np.arange(4), 2, (4,)))
    return (be.launches - calls, be.bootstraps - boots), dict(cc.argmin_counts)


@pytest.mark.parametrize("proto,device", [(PROTO, "cpu"), (FULL, "meta")], ids=["toy", "full"])
def test_the_tournament_counter_is_countingbackends_and_resets(proto, device):
    (calls, boots), counts = _tournament_counts(proto, device)
    assert counts == {"calls": calls, "bootstraps": boots}
    if proto is FULL:
        assert counts == {"calls": 54, "bootstraps": 372}
    cc.reset_argmin_counts()
    assert cc.argmin_counts == {"calls": 0, "bootstraps": 0}


def test_the_counter_stays_still_on_the_one_to_one_circuit():
    be = CountingBackend()
    cc.reset_argmin_counts()
    bits = int_to_bits(np.array([[3, 5], [6, 1]]), 3, "cpu")
    cc.function_f(be, bits, bits.flip(0), int_to_bits(np.array([4, 4]), 9, "cpu"), 3)
    assert be.bootstraps > 0
    assert cc.argmin_counts == {"calls": 0, "bootstraps": 0}


def test_the_replay_of_a_request_counts_as_countingbackend():
    """The kind's shape-only replay (what its set-up warms) makes the calls
    and bootstraps that the clear circuit makes."""
    calls = identify_closed.replay_calls(PROTO, 4, PARAMS.n)
    be = CountingBackend()
    bits = int_to_bits(np.zeros((4, PROTO.nslots), np.int64), PROTO.bitsize, "cpu")
    d = cc.euclidean(be, bits[0].expand(bits.shape), bits, PROTO.bitsize, PROTO.max_bitsize)
    cc.argmin_tree(be, d, cc.const_word(be, np.arange(4), 2, (4,)))
    assert len(calls) == be.launches
    assert sum(b for _, _, b in calls) == be.bootstraps


def test_both_spans_open_under_a_cpu_profiler():
    server = Server(None, PROTO)
    server.be = identify_closed.Shapes(PARAMS.n)          # ciphertexts of shapes alone
    probe, templates = server.be.ct((2, 3)), server.be.ct((3, 2, 3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        server.identify_argmin(probe, templates)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("peba1.identify."))
    assert [name for _, _, name in spans] == ["peba1.identify.distance",
                                              "peba1.identify.argmin"]
    assert spans[0][1] <= spans[1][0]
