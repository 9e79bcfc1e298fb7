"""Keys and ciphertexts cross between peba1_tpu and the port through the npz
format (FORMAT_VERSION 1), unchanged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import keys as jkeys
from peba1_tpu import lwe as jlwe
from peba1_tpu.io import serial as jserial
from peba1_tpu.params import TOY, TOY_T2
from peba1_tpu.ops import poly as jpoly
from peba1_tpu_torch import gates, keys, lwe
from peba1_tpu_torch.io import serial
from peba1_tpu_torch.ops import bootstrap as bs

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

P = dataclasses.replace(TOY_T2, use_gen_step=True)


@pytest.fixture(scope="module")
def jax_keys():
    return jkeys.keygen(jax.random.PRNGKey(21), P)


def test_reference_keys_load_in_the_port(tmp_path, jax_keys):
    sk, ck = jax_keys
    jserial.save_secret_key(str(tmp_path / "sk.npz"), sk)
    jserial.save_cloud_key(str(tmp_path / "ck.npz"), ck)
    tsk = serial.load_secret_key(str(tmp_path / "sk.npz"), "cpu")
    tck = serial.load_cloud_key(str(tmp_path / "ck.npz"), "cpu")
    assert dataclasses.asdict(tsk.params) == dataclasses.asdict(sk.params)
    assert dataclasses.asdict(tck.params) == dataclasses.asdict(ck.params)
    for got, want in ((tsk.lwe_key, sk.lwe_key), (tsk.tlwe_key, sk.tlwe_key),
                      (tck.bk_tp, ck.bk_tp), (tck.ks_table_limbs, ck.ks_table_limbs),
                      (tck.bk, ck.bk)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the loaded key bootstraps: decrypts under the loaded secret key
    bits = np.arange(9) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(1), tsk, bits)
    out = bs.bootstrap(tck, lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8), gates.MU_1_8)
    np.testing.assert_array_equal(gates.decrypt_bits(out, tsk).numpy(), bits)


def test_port_keys_load_in_the_reference(tmp_path):
    sk, ck = keys.keygen(torch.Generator().manual_seed(22), P, "cpu")
    serial.save_secret_key(str(tmp_path / "sk.npz"), sk)
    serial.save_cloud_key(str(tmp_path / "ck.npz"), ck)
    jsk = jserial.load_secret_key(str(tmp_path / "sk.npz"))
    jck = jserial.load_cloud_key(str(tmp_path / "ck.npz"))
    assert dataclasses.asdict(jck.params) == dataclasses.asdict(P)
    assert dataclasses.asdict(jsk.params) == dataclasses.asdict(P)
    np.testing.assert_array_equal(np.asarray(jck.bk_tp), ck.bk_tp.numpy())
    np.testing.assert_array_equal(np.asarray(jsk.lwe_key), sk.lwe_key.numpy())
    # bk_conv, derived here by the port, equals the reference's derivation
    want = jax.vmap(lambda g: jkeys.poly.prepare_conv_rhs(g, P.limb_plan))(jnp.asarray(jck.bk))
    np.testing.assert_array_equal(np.asarray(jck.bk_conv), np.asarray(want))
    want_tp = jax.vmap(lambda g: jkeys.poly.prepare_toeplitz_rhs(g, P.limb_plan))(jnp.asarray(jck.bk))
    np.testing.assert_array_equal(np.asarray(want_tp), ck.bk_tp.numpy())


def test_reference_t2_key_loads_with_bk_w_rebuilt(tmp_path):
    """TOY_T2 selects cmux_step against bk_w; neither package stores bk_w, so
    the port rebuilds it on load, equal (in its transposed layout) to the
    JAX package's."""
    sk, ck = jkeys.keygen(jax.random.PRNGKey(23), TOY_T2)
    jserial.save_cloud_key(str(tmp_path / "ck.npz"), ck)
    tck = serial.load_cloud_key(str(tmp_path / "ck.npz"), "cpu")
    assert keys.need_w(tck.params) and ck.bk_w is not None
    np.testing.assert_array_equal(tck.bk_w.transpose(1, 2).numpy(), np.asarray(ck.bk_w))
    np.testing.assert_array_equal(np.asarray(jpoly.prepare_w_full(ck.bk_tp)),
                                  np.asarray(ck.bk_w))
    tsk = keys.secret_key_from_numpy(TOY_T2, np.array(sk.lwe_key), np.array(sk.tlwe_key),
                                     "cpu")
    bits = np.arange(7) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(4), tsk, bits)
    out = bs.bootstrap(tck, lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8), gates.MU_1_8)
    np.testing.assert_array_equal(gates.decrypt_bits(out, tsk).numpy(), bits)


def test_ciphertexts_cross_both_ways(tmp_path, jax_keys):
    sk, _ = jax_keys
    ct = jlwe.encrypt(jax.random.PRNGKey(3), sk.lwe_key, jnp.arange(6, dtype=jnp.int32),
                      P.lwe_stdev)
    jserial.save_ciphertext(str(tmp_path / "a.npz"), ct, {"who": "jax"})
    tct, meta = serial.load_ciphertext(str(tmp_path / "a.npz"), "cpu")
    assert meta["who"] == "jax"
    np.testing.assert_array_equal(tct.a.numpy(), np.asarray(ct.a))
    serial.save_ciphertext(str(tmp_path / "b.npz"), tct, {"who": "torch"})
    back, meta = jserial.load_ciphertext(str(tmp_path / "b.npz"))
    assert meta["who"] == "torch"
    np.testing.assert_array_equal(np.asarray(back.b), np.asarray(ct.b))


def test_loaded_key_shapes_are_checked():
    with pytest.raises(ValueError):
        keys.cloud_key_from_numpy(P, np.zeros((P.n, 6, 11, 8), np.int8),
                                  np.zeros((1, 1), np.int8), "cpu")


FUSED = dataclasses.replace(TOY, use_fused_cmux=True)


def test_reference_fused_key_loads_with_bk_amat_rebuilt(tmp_path):
    """Neither package stores bk_amat: the port rebuilds it on load, equal
    (in its transposed layout) to the one JAX's keygen built, and carries
    JAX's bk_conv as stored."""
    sk, ck = jkeys.keygen(jax.random.PRNGKey(24), FUSED)
    jserial.save_cloud_key(str(tmp_path / "ck.npz"), ck)
    tck = serial.load_cloud_key(str(tmp_path / "ck.npz"), "cpu")
    assert keys.need_amat(tck.params) and ck.bk_amat is not None and tck.bk_w is None
    np.testing.assert_array_equal(tck.bk_amat.transpose(-1, -2).numpy(),
                                  np.asarray(ck.bk_amat))
    np.testing.assert_array_equal(tck.bk_conv.numpy(), np.asarray(ck.bk_conv))
    tsk = keys.secret_key_from_numpy(FUSED, np.array(sk.lwe_key), np.array(sk.tlwe_key),
                                     "cpu")
    bits = np.arange(7) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(5), tsk, bits)
    out = bs.bootstrap(tck, lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8), gates.MU_1_8)
    np.testing.assert_array_equal(gates.decrypt_bits(out, tsk).numpy(), bits)


def test_port_fused_key_loads_in_the_reference(tmp_path):
    sk, ck = keys.keygen(torch.Generator().manual_seed(25), FUSED, "cpu")
    serial.save_cloud_key(str(tmp_path / "ck.npz"), ck)
    jck = jserial.load_cloud_key(str(tmp_path / "ck.npz"))
    np.testing.assert_array_equal(np.asarray(jck.bk_amat),
                                  ck.bk_amat.transpose(-1, -2).numpy())
    np.testing.assert_array_equal(np.asarray(jck.bk_conv), ck.bk_conv.numpy())
    back = serial.load_cloud_key(str(tmp_path / "ck.npz"), "cpu")
    assert torch.equal(back.bk_amat, ck.bk_amat) and torch.equal(back.bk_conv, ck.bk_conv)


def test_ciphertext_meta_alone(tmp_path):
    ct = lwe.Lwe(torch.arange(6, dtype=torch.int32).view(2, 3),
                 torch.arange(2, dtype=torch.int32))
    serial.save_ciphertext(str(tmp_path / "c.npz"), ct, {"chunk": 4})
    assert serial.load_ciphertext_meta(str(tmp_path / "c.npz")) == {
        "format_version": 1, "chunk": 4}
    assert jserial.load_ciphertext_meta(str(tmp_path / "c.npz"))["chunk"] == 4
