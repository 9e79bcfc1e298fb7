"""The port's core API against peba1_tpu: the torus, LWE, TRLWE, gadget,
gate, protocol and printing functions, on numpy inputs from a seed.

Integer results must be equal (no tolerance); `torus32_to_double` equal in
float32 (JAX's default precision) and in float64 (JAX with x64).  Where
fresh randomness enters (keygen, encryption), the two packages cannot draw
alike, so the checks are on tensors carried from one to the other, or on
decryptions.  The last part holds the port to the JAX package's own
properties (tests/test_core.py: decompose/recompose precision, TRLWE
round-trip, sample extract, TRGSW external product).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import gates as jgates
from peba1_tpu import keys as jkeys
from peba1_tpu import lwe as jlwe
from peba1_tpu import tlwe as jtlwe
from peba1_tpu import torus as jtorus
from peba1_tpu.ops import decompose as jdec
from peba1_tpu.ops import poly as jpoly
from peba1_tpu.params import TOY, TOY_T2
from peba1_tpu.utils import printing as jprinting
from peba1_tpu_torch import conformance as cf
from peba1_tpu_torch import gates, keys, lwe, protocol, tlwe, torus
from peba1_tpu_torch.ops import decompose as dec
from peba1_tpu_torch.ops import poly
from peba1_tpu_torch.params import PRESETS, ProtocolParams
from peba1_tpu_torch.utils import printing

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores.
torch.set_num_threads(1)

PARAMS = {"toy": TOY, "toy_t2": TOY_T2, "ring_2048": PRESETS["ring_2048"]}


def rand_i32(seed, shape):
    x = np.random.default_rng(seed).integers(-2**31, 2**31, shape, dtype=np.int64)
    x.reshape(-1)[:4] = [-2**31, 2**31 - 1, 0, -1]
    return x.astype(np.int32)


def eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.cpu().numpy())


def reals(seed):
    """Doubles mod 1 and outside [0, 1), with the rounding edges planted."""
    x = np.random.default_rng(seed).uniform(-3.0, 3.0, 257)
    x[:8] = [0.0, 0.5, -0.5, 0.25, 1 - 2**-40, -2**-40, 2**-33, 1e6 + 0.3]
    return x


# ---------------------------------------------------------------- torus


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_double_and_torus32(x64):
    x, t = reals(1), rand_i32(2, (300,))
    dtype = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        want_t = np.asarray(jtorus.double_to_torus32(x))
        want_d = np.asarray(jtorus.torus32_to_double(jnp.asarray(t)))
    got_t = torus.double_to_torus32(x, dtype)
    got_d = torus.torus32_to_double(torch.as_tensor(t), dtype)
    assert got_t.dtype == torch.int32 and got_d.dtype == dtype
    np.testing.assert_array_equal(want_t, got_t.numpy())
    assert want_d.dtype == got_d.numpy().dtype
    np.testing.assert_array_equal(want_d, got_d.numpy())


def test_torus_round_trip():
    t = torch.as_tensor(rand_i32(3, (100,)))
    back = torus.double_to_torus32(torus.torus32_to_double(t, torch.float64),
                                   torch.float64)
    assert torch.equal(back, t)


# ---------------------------------------------------------------- LWE, gadget


def test_lwe_where():
    rng = np.random.default_rng(4)
    xa, xb, ya, yb = (rand_i32(s, sh) for s, sh in
                      ((5, (3, 4, 7)), (6, (3, 4)), (7, (3, 4, 7)), (8, (3, 4))))
    pred = rng.integers(0, 2, (3, 4)).astype(bool)
    want = jlwe.where(jnp.asarray(pred), jlwe.Lwe(jnp.asarray(xa), jnp.asarray(xb)),
                      jlwe.Lwe(jnp.asarray(ya), jnp.asarray(yb)))
    got = lwe.where(torch.as_tensor(pred), lwe.Lwe(torch.as_tensor(xa), torch.as_tensor(xb)),
                    lwe.Lwe(torch.as_tensor(ya), torch.as_tensor(yb)))
    eq(want.a, got.a)
    eq(want.b, got.b)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_recompose(name):
    p = PARAMS[name]
    d = np.random.default_rng(9).integers(-p.half_bg, p.half_bg, (5, 64, p.l)).astype(np.int8)
    d[0, 0, :] = -p.half_bg
    eq(jdec.recompose(jnp.asarray(d), p), dec.recompose(torch.as_tensor(d), p))
    x = rand_i32(10, (4, 33))
    eq(jdec.recompose(jdec.decompose(jnp.asarray(x), p), p),
       dec.recompose(dec.decompose(torch.as_tensor(x), p), p))


# ---------------------------------------------------------------- TRLWE


@pytest.mark.parametrize("name", ["toy", "toy_t2"])
def test_trlwe_trivial_and_phase(name):
    p = PARAMS[name]
    mu = rand_i32(11, (3, p.N))
    eq(jtlwe.trivial(jnp.asarray(mu), p), tlwe.trivial(torch.as_tensor(mu), p))
    ct = rand_i32(12, (3, p.k + 1, p.N))
    key = np.random.default_rng(13).integers(0, 2, (p.k, p.N)).astype(np.int32)
    eq(jtlwe.phase(jnp.asarray(ct), jnp.asarray(key)),
       tlwe.phase(torch.as_tensor(ct), torch.as_tensor(key)))


def test_trlwe_encrypt_is_a_zero_encryption_plus_the_message():
    """The port's draws: encrypt = encrypt_zero on the same generator state,
    with mu added to the body; its phase under the key is mu at TOY (no
    noise), computed alike by both packages."""
    mu = torch.as_tensor(rand_i32(14, (2, TOY.N)))
    key = torch.as_tensor(np.random.default_rng(15).integers(0, 2, (1, TOY.N)).astype(np.int32))
    ct = tlwe.encrypt(torch.Generator().manual_seed(5), key, mu, TOY)
    z = tlwe.encrypt_zero(torch.Generator().manual_seed(5), key, TOY, shape=(2,))
    z[..., -1, :] += mu
    assert torch.equal(ct, z)
    assert torch.equal(tlwe.phase(ct, key), mu)
    eq(jtlwe.phase(jnp.asarray(ct.numpy()), jnp.asarray(key.numpy())), tlwe.phase(ct, key))


def test_negacyclic_extproduct_reference():
    G, O, N, B = 4, 3, 32, 5
    d, q = rand_i32(16, (B, G, N)), rand_i32(17, (G, O, N))
    eq(jpoly.negacyclic_extproduct_reference(jnp.asarray(d), jnp.asarray(q)),
       poly.negacyclic_extproduct_reference(torch.as_tensor(d), torch.as_tensor(q)))


@pytest.mark.parametrize("name", ["toy", "toy_t2"])
def test_external_product_reference(name):
    p = PARAMS[name]
    trlwe = rand_i32(18, (2, 3, p.k + 1, p.N))
    trgsw = rand_i32(19, ((p.k + 1) * p.l, p.k + 1, p.N))
    want = jtlwe.external_product_reference(functools.partial(jdec.decompose, params=p),
                                            jnp.asarray(trlwe), jnp.asarray(trgsw), p)
    got = tlwe.external_product_reference(functools.partial(dec.decompose, params=p),
                                          torch.as_tensor(trlwe), torch.as_tensor(trgsw), p)
    assert got.shape == (2, 3, p.k + 1, p.N)
    eq(want, got)


# ---------------------------------------------------------------- gates


@pytest.fixture(scope="module")
def toy_carried():
    """A JAX TOY keyset, its cloud key carried into the port."""
    sk, ck = jkeys.keygen(jax.random.PRNGKey(3), TOY)
    return sk, ck, keys.cloud_key_from_numpy(TOY, np.asarray(ck.bk_tp),
                                             np.asarray(ck.ks_table_limbs), "cpu")


def test_gate_bootstrap(toy_carried):
    jsk, jck, tck = toy_carried
    bits = np.random.default_rng(20).integers(0, 2, (3, 5))
    ct = jgates.encrypt_bits(jax.random.PRNGKey(21), jsk, jnp.asarray(bits))
    pre = jlwe.Lwe(ct.a * 2, ct.b * 2 + jnp.int32(-jgates.MU_1_8))
    want = jgates.gate_bootstrap(jck, pre)
    got = gates.gate_bootstrap(tck, lwe.Lwe(torch.as_tensor(np.asarray(pre.a)),
                                            torch.as_tensor(np.asarray(pre.b))))
    assert got.shape == (3, 5)
    eq(want.a, got.a)
    eq(want.b, got.b)
    np.testing.assert_array_equal(np.asarray(jgates.decrypt_bits(want, jsk)), bits)


# ---------------------------------------------------------------- protocol


def test_make_system_and_client_record():
    proto = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)
    client, server = protocol.make_system(torch.Generator().manual_seed(4), TOY, "cpu",
                                          proto=proto)
    assert client.client_id == 7 and client.minimum_lambda == 128
    assert server.ck is client.ck and client.sk.params == TOY and server.proto == proto
    rec = client.enroll(torch.Generator().manual_seed(5), [3, 6])
    server.register(rec)
    assert server.db[7] is rec
    assert rec.get_id() == 7 and rec.get_nb_slots() == 2
    assert rec.get_ctxt() is rec.template_ct and rec.get_ctxt().shape == (2, 3)
    np.testing.assert_array_equal(client.decrypt_word(rec.get_ctxt()), [3, 6])
    assert protocol.ClientDevice(1, client.sk, None, proto, minimum_lambda=80).minimum_lambda == 80


def test_eval_cipher_in_chunks_equals_one_batch():
    corpus = cf.make_corpus(4, nslots=2, bitsize=2, seed=1)
    sk, ck = keys.keygen(torch.Generator().manual_seed(6), TOY, "cpu")
    whole = cf.eval_cipher(sk, ck, corpus, torch.Generator().manual_seed(7))
    chunked = cf.eval_cipher(sk, ck, corpus, torch.Generator().manual_seed(8), batch=2)
    _, _, _, _, _, want_b, want_y = cf.corpus_arrays(corpus)
    for b, y in (whole, chunked):
        np.testing.assert_array_equal(b, want_b)
        np.testing.assert_array_equal(y, want_y)


# ---------------------------------------------------------------- printing


@pytest.mark.parametrize("size", [None, 3])
def test_printing(capsys, size):
    v = np.array([0, 7, 255, 1, 128])
    want = [jprinting.print_vector(v, size), jprinting.print_vect64(v, size),
            jprinting.print_slot64(5), jprinting.print_slot64(2**63 + 9)]
    want_out = capsys.readouterr().out
    got = [printing.print_vector(torch.as_tensor(v), size), printing.print_vect64(v, size),
           printing.print_slot64(5), printing.print_slot64(2**63 + 9)]
    assert got == want and capsys.readouterr().out == want_out


# ------------------------------------------- the JAX package's core properties


def test_decompose_recompose_precision():
    x = np.random.default_rng(4).integers(-2**31, 2**31, (256,), dtype=np.int64)
    d = dec.decompose(torch.as_tensor(x.astype(np.int32)), TOY)
    assert int(d.min()) >= -TOY.half_bg and int(d.max()) < TOY.half_bg
    err = (dec.recompose(d, TOY).numpy().astype(np.int64) - x) % (1 << 32)
    err = np.minimum(err, (1 << 32) - err)
    # The reconstruction drops the low 32 - l*bgbit bits of (x + offset).
    assert err.max() < 1 << (32 - TOY.l * TOY.bgbit)


@pytest.fixture(scope="module")
def toy_sk():
    return keys.secret_keygen(torch.Generator().manual_seed(42), TOY, "cpu")


def test_trlwe_roundtrip(toy_sk):
    mu = torch.arange(TOY.N, dtype=torch.int32) * 65537
    ct = tlwe.encrypt(torch.Generator().manual_seed(9), toy_sk.tlwe_key, mu, TOY)
    assert torch.equal(tlwe.phase(ct, toy_sk.tlwe_key), mu)


def test_sample_extract_consistency(toy_sk):
    mu = torch.arange(TOY.N, dtype=torch.int32) * 31337
    ct = tlwe.encrypt(torch.Generator().manual_seed(10), toy_sk.tlwe_key, mu, TOY)
    a_ext, b_ext = tlwe.sample_extract(ct)
    assert int(b_ext - poly.dot_key_i32(a_ext, toy_sk.extracted_key)) == int(mu[0])


def test_trgsw_external_product(toy_sk):
    """ext_product(TRLWE(m), TRGSW(bit)) ~ TRLWE(bit * m)."""
    mu = (torch.arange(TOY.N, dtype=torch.int32) % 7 - 3) << 26
    ct = tlwe.encrypt(torch.Generator().manual_seed(11), toy_sk.tlwe_key, mu, TOY)
    dfn = functools.partial(dec.decompose, params=TOY)
    for bit in (0, 1):
        g = tlwe.trgsw_encrypt(torch.Generator().manual_seed(12), toy_sk.tlwe_key,
                               torch.tensor(bit, dtype=torch.int32), TOY)
        prod = tlwe.external_product_reference(dfn, ct[None], g, TOY)[0]
        ph = tlwe.phase(prod, toy_sk.tlwe_key).numpy().astype(np.int64)
        err = (ph - bit * mu.numpy().astype(np.int64)) % (1 << 32)
        err = np.minimum(err, (1 << 32) - err)
        assert err.max() < 2 ** (32 - TOY.l * TOY.bgbit) * TOY.N * (TOY.k + 1) * TOY.l
