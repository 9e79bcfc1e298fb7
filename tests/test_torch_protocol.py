"""Circuits and protocol of the port against peba1_tpu.

* function_f / function_g bit-equal to the reference's on carried keys and
  ciphertexts (TOY_T2 with use_gen_step, nslots=2, bitsize=3, same nonces);
* authenticate decisions with the port's own keygen (TOY);
* the 64-case golden corpus at full width (nslots=128, bitsize=8) on the
  port's ClearBackend, and the clear circuits against the reference's.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from peba1_tpu import backends as jbackends
from peba1_tpu import circuits as jcc
from peba1_tpu import gates as jgates
from peba1_tpu import keys as jkeys
from peba1_tpu.params import TOY, TOY_T2
from peba1_tpu.utils.bits import int_to_bits as j_int_to_bits
from peba1_tpu_torch import circuits as cc
from peba1_tpu_torch import conformance as cf
from peba1_tpu_torch import keys, lwe
from peba1_tpu_torch.backends import CipherBackend, ClearBackend, CountingBackend
from peba1_tpu_torch.params import ProtocolParams
from peba1_tpu_torch.protocol import ClientDevice, Server
from peba1_tpu_torch.utils.bits import bits_to_int, int_to_bits

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

PROTO = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)
P_GEN = dataclasses.replace(TOY_T2, use_gen_step=True)
CORPUS = os.path.join(os.path.dirname(__file__), "data", "golden_corpus.json")


def _plain(base):
    return dataclasses.replace(
        base, use_fused_cmux=False, use_pallas_rotate=False,
        use_pallas_extprod=False, use_fused_step=False, use_gen_step=False,
        use_gen_full=False)


def to_port(ct):
    return lwe.Lwe(torch.as_tensor(np.array(ct.a)), torch.as_tensor(np.array(ct.b)))


@pytest.fixture(scope="module")
def f_and_g():
    """function_f then function_g on both packages, same inputs and nonces."""
    sk, ck = jkeys.keygen(jax.random.PRNGKey(0), P_GEN)
    jbe = jbackends.CipherBackend(ck.replace(params=_plain(P_GEN)))
    tbe = CipherBackend(keys.cloud_key_from_numpy(
        P_GEN, np.array(ck.bk_tp), np.array(ck.ks_table_limbs), "cpu"))
    template = np.array([[2, 7], [3, 5]])
    probe = np.array([[3, 4], [4, 6]])                 # ED 10 > 4, ED 2 <= 4
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    et = jgates.encrypt_bits(k1, sk, j_int_to_bits(template, 3))
    ep = jgates.encrypt_bits(k2, sk, j_int_to_bits(probe, 3))
    eb = jgates.encrypt_bits(k3, sk, j_int_to_bits([4, 4], 9))
    r0, r1 = np.array([5, 6]), np.array([3, 1])
    jb = jcc.function_f(jbe, ep, et, eb, 3)
    jy = jcc.function_g(jbe, jb, jcc.const_word(jbe, r0, 3, (2,)),
                        jcc.const_word(jbe, r1, 3, (2,)), 3)
    tb = cc.function_f(tbe, to_port(ep), to_port(et), to_port(eb), 3)
    ty = cc.function_g(tbe, tb, cc.const_word(tbe, r0, 3, (2,)),
                       cc.const_word(tbe, r1, 3, (2,)), 3)
    dec = lambda ct: np.asarray(jgates.decrypt_bits(ct, sk))
    return {"jax": (jb, jy), "torch": (tb, ty), "dec": dec,
            "launches": (jbe.launches, tbe.launches)}


@pytest.mark.parametrize("which", ["function_f", "function_g"])
def test_bit_equal_to_reference(f_and_g, which):
    i = 0 if which == "function_f" else 1
    want, got = f_and_g["jax"][i], f_and_g["torch"][i]
    np.testing.assert_array_equal(np.asarray(want.a), got.a.numpy())
    np.testing.assert_array_equal(np.asarray(want.b), got.b.numpy())


def test_decisions_and_schedule_match(f_and_g):
    b = bits_to_int(f_and_g["dec"](f_and_g["jax"][0]))
    y = bits_to_int(f_and_g["dec"](f_and_g["jax"][1]))
    np.testing.assert_array_equal(b, [1, 0])
    np.testing.assert_array_equal(y, [3, (-6) % 8])   # r1, then -r0 mod 2^3
    assert f_and_g["launches"][0] == f_and_g["launches"][1]


@pytest.fixture(scope="module")
def port_auth():
    """One batched authenticate call with the port's keygen: a match and a
    non-match request."""
    gen = torch.Generator().manual_seed(31)
    sk, ck = keys.keygen(gen, TOY, "cpu")
    client, server = ClientDevice(7, sk, ck, PROTO), Server(ck, PROTO)
    template = np.array([[3, 5], [3, 5]])
    probe = np.array([[4, 6], [6, 1]])                 # ED 2 <= 4, ED 25 > 4
    rec = client.enroll(gen, template)
    server.register(rec)
    res = server.authenticate(gen, client.encrypt_vector(gen, probe), rec.template_ct,
                              client.encrypt_word(gen, [4, 4], 9))
    y = client.prove(res.enc_y)
    return client.decrypt_word(res.enc_b), y, res, server.verify_proof(res, y)


def test_authenticate_match(port_auth):
    b, y, res, v = port_auth
    assert b[0] == 0
    assert y[0] == (-int(res.r0[0])) % 8
    assert bool(v["is_match"][0]) or y[0] == res.r1[0]   # r collision tolerated


def test_authenticate_nonmatch(port_auth):
    b, y, res, v = port_auth
    assert b[1] == 1
    assert y[1] == res.r1[1]
    assert bool(v["reference_verdict"][1])


@pytest.fixture(scope="module")
def one_to_n():
    """A probe and three enrolled templates, ED(probe, t) = [2, 29, 0]."""
    gen = torch.Generator().manual_seed(32)
    sk, ck = keys.keygen(gen, TOY, "cpu")
    client, server = ClientDevice(7, sk, ck, PROTO), Server(ck, PROTO)
    t_ct = client.encrypt_vector(gen, np.array([[3, 5], [6, 1], [4, 6]]))
    p_ct = client.encrypt_vector(gen, np.array([4, 6]))
    return gen, client, server, t_ct, p_ct


def test_identify(one_to_n):
    gen, client, server, t_ct, p_ct = one_to_n
    out = server.identify(p_ct, t_ct, client.encrypt_word(gen, 4, 9))
    np.testing.assert_array_equal(client.decrypt_word(out), [0, 1, 0])


def test_identify_argmin(one_to_n):
    _, client, server, t_ct, p_ct = one_to_n
    dist, idx = server.identify_argmin(p_ct, t_ct)
    assert int(client.decrypt_word(dist)) == 0
    assert int(client.decrypt_word(idx)) == 2


def test_golden_corpus_full_width_on_clear_backend():
    corpus = cf.load_corpus(CORPUS)
    assert cf.make_corpus(corpus["n_cases"], corpus["nslots"], corpus["bitsize"],
                          corpus["seed"]) == corpus
    _, _, _, _, _, want_b, want_y = cf.corpus_arrays(corpus)
    b_word, y_word = cf.eval_circuit(ClearBackend(), corpus)
    np.testing.assert_array_equal(bits_to_int(b_word), want_b)
    np.testing.assert_array_equal(bits_to_int(y_word), want_y)


def test_eval_cipher_on_a_toy_corpus():
    """The cipher route of the corpus, at toy width with the port's keygen:
    one match, one non-match, one tie (b=0) and one near-tie (b=1)."""
    corpus = cf.make_corpus(4, nslots=2, bitsize=2, seed=1)
    assert [c["b"] for c in corpus["cases"]] == [0, 1, 0, 1]
    gen = torch.Generator().manual_seed(33)
    sk, ck = keys.keygen(gen, TOY, "cpu")
    b, y = cf.eval_cipher(sk, ck, corpus, gen)
    _, _, _, _, _, want_b, want_y = cf.corpus_arrays(corpus)
    np.testing.assert_array_equal(b, want_b)
    np.testing.assert_array_equal(y, want_y)


def test_counted_bootstraps_match_reference():
    """216,176 gates per full-width match is the reference's mechanical
    count (BENCH_matches_r05.json); the port's circuits count the same."""
    t = np.random.default_rng(0).integers(1, 255, (1, 128))
    outs = []
    for be, bits in ((jbackends.CountingBackend(), j_int_to_bits),
                     (CountingBackend(), lambda v, n: int_to_bits(v, n, "cpu"))):
        mod = jcc if isinstance(be, jbackends.CountingBackend) else cc
        f = mod.function_f(be, bits(t + 1, 8), bits(t, 8), bits([256], 24), 8)
        mod.function_g(be, f, bits([0], 8), bits([0], 8), 8)
        outs.append(be.bootstraps)
    assert outs[0] == outs[1] == 216176


RNG = np.random.default_rng(40)
X, Y = RNG.integers(0, 32, 24), RNG.integers(0, 32, 24)


@pytest.mark.parametrize("op", ["add_n", "twos_complement", "abs_n", "sub_abs",
                                "multiply", "minimum", "manhattan", "euclidean",
                                "argmin_tree", "shift_left", "shift_right"])
def test_clear_circuits_match_reference(op):
    jbe, tbe = jbackends.ClearBackend(), ClearBackend()
    jx, jy = j_int_to_bits(X, 5), j_int_to_bits(Y, 5)
    tx, ty = int_to_bits(X, 5, "cpu"), int_to_bits(Y, 5, "cpu")
    calls = {
        "add_n": lambda m, be, x, y: m.add_n(be, x, y, 5),
        "twos_complement": lambda m, be, x, y: m.twos_complement(be, x, 5),
        "abs_n": lambda m, be, x, y: m.abs_n(be, x, 5),
        "sub_abs": lambda m, be, x, y: m.sub_abs(be, x, y, 5),
        "multiply": lambda m, be, x, y: m.multiply(be, x, y, 5, length=11),
        "minimum": lambda m, be, x, y: m.minimum(be, x, y, 5),
        "manhattan": lambda m, be, x, y: m.manhattan(be, x.reshape(4, 6, 5),
                                                     y.reshape(4, 6, 5), 5),
        "euclidean": lambda m, be, x, y: m.euclidean(be, x.reshape(4, 6, 5),
                                                     y.reshape(4, 6, 5), 5, 15),
        "argmin_tree": lambda m, be, x, y: m.argmin_tree(be, x[:7], y[:7, :3]),
        "shift_left": lambda m, be, x, y: m.shift_left(be, x, 5, 2),
        "shift_right": lambda m, be, x, y: m.shift_right(be, x, 5, 2),
    }
    want = calls[op](jcc, jbe, jx, jy)
    got = calls[op](cc, tbe, tx, ty)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
