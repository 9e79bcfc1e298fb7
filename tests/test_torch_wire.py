"""The port's wire codec (peba1_tpu_torch.io.wire), the counterparts of
tests/test_wire.py, and the same bytes as peba1_tpu.io.wire."""

import jax
import numpy as np
import pytest
import torch

from peba1_tpu import gates as jgates
from peba1_tpu.io import wire as jwire
from peba1_tpu_torch import gates, keys, lwe
from peba1_tpu_torch.io import wire

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)


def test_crc32c_vector():
    # RFC 3720 test vector, through the native path and the fallback
    assert wire.crc32c(b"123456789") == 0xE3069283
    assert wire.crc32c_py(b"123456789") == 0xE3069283


def test_frame_roundtrip():
    f = wire.frame_encode(2, b"payload bytes")
    assert f == jwire.frame_encode(2, b"payload bytes")
    kind, ver, payload = wire.frame_decode(f)
    assert (kind, ver, payload) == (2, 1, b"payload bytes")


def test_frame_corruption_detected():
    f = bytearray(wire.frame_encode(1, b"sensitive"))
    f[-3] ^= 0xFF
    with pytest.raises(ValueError):
        wire.frame_decode(bytes(f))


def test_bit_slice_roundtrip():
    v = np.random.default_rng(0).integers(0, 2**24, (7, 5))
    bits = wire.bit_slice(v, 24)
    assert bits.shape == (7, 5, 24)
    np.testing.assert_array_equal(wire.bit_unslice(bits), v)
    np.testing.assert_array_equal(bits, jwire.bit_slice(v, 24))


def test_native_matches_fallback():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2**16, 64)
    np.testing.assert_array_equal(wire.bit_slice(v, 16), wire.bit_slice_py(v, 16))
    data = rng.integers(0, 256, 999, dtype=np.uint8).tobytes()
    assert wire.crc32c(data) == wire.crc32c_py(data) == jwire.crc32c(data)
    assert wire.crc32c(data, seed=7) == wire.crc32c_py(data, seed=7)


@pytest.fixture(scope="module")
def port_sk(toy_keys):
    sk, _ = toy_keys
    return keys.secret_key_from_numpy(sk.params, np.array(sk.lwe_key),
                                      np.array(sk.tlwe_key), "cpu")


def test_ciphertext_wire_roundtrip(port_sk):
    bits = np.asarray([[1, 0, 1], [0, 1, 1]])
    ct = gates.encrypt_bits(torch.Generator().manual_seed(0), port_sk, bits)
    blob = wire.encode_ciphertext(ct, meta={"kind": "bits"})
    ct2, meta = wire.decode_ciphertext(blob, "cpu")
    assert meta == {"kind": "bits"}
    assert torch.equal(ct2.a, ct.a) and torch.equal(ct2.b, ct.b)
    np.testing.assert_array_equal(gates.decrypt_bits(ct2, port_sk).numpy(), bits)


def test_ciphertext_bytes_equal_to_reference(toy_keys):
    """The same tensors encode to the same frame in both packages, and each
    package decodes the other's frame to the same tensors."""
    sk, _ = toy_keys
    bits = np.asarray([[1, 0, 1, 1], [0, 1, 1, 0]])
    jct = jgates.encrypt_bits(jax.random.PRNGKey(5), sk, bits)
    tct = lwe.Lwe(torch.as_tensor(np.array(jct.a)), torch.as_tensor(np.array(jct.b)))
    blob = wire.encode_ciphertext(tct, meta={"who": "either"})
    assert blob == jwire.encode_ciphertext(jct, meta={"who": "either"})
    back, meta = jwire.decode_ciphertext(blob)
    assert meta == {"who": "either"}
    np.testing.assert_array_equal(np.asarray(back.a), tct.a.numpy())
    mine, _ = wire.decode_ciphertext(jwire.encode_ciphertext(jct), "cpu")
    np.testing.assert_array_equal(mine.b.numpy(), np.asarray(jct.b))
