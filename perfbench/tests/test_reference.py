"""The plain reference against known answers at toy sizes.  Imports nothing
of the program."""

import numpy as np
import pytest
import torch

from perfbench import material
from perfbench.reference import peba1
from perfbench.reference import tfhe as ref

TOY = ref.Lattice(n=16, N=64, k=1, l=2, bgbit=8, ks_t=8, ks_basebit=2, bk_limbs=4,
                  bk_body_limbs=3, lwe_stdev=0.0, tlwe_stdev=0.0)
TOY_K2 = ref.Lattice(n=16, N=32, k=2, l=2, bgbit=8, ks_t=8, ks_basebit=2, bk_limbs=4,
                     bk_body_limbs=3, lwe_stdev=2.0**-15, tlwe_stdev=2.0**-25)


def naive_negacyclic(p, q):
    """p * q mod X^N + 1 by the schoolbook loop, Python integers."""
    N = len(p)
    out = [0] * N
    for i in range(N):
        for j in range(N):
            s = 1 if i + j < N else -1
            out[(i + j) % N] += s * p[i] * q[j]
    return [x % (1 << 32) for x in out]


def test_negacyclic_matrix_is_the_ring_product():
    rng = np.random.default_rng(0)
    p = rng.integers(-128, 128, 16)
    q = rng.integers(-2**31, 2**31, 16)
    got = (torch.as_tensor(p) @ ref.negacyclic_matrix(torch.as_tensor(q))) & ref.MASK32
    assert got.tolist() == naive_negacyclic(p.tolist(), q.tolist())


def test_rotate_by_n_negates_and_by_2n_is_identity():
    p = torch.arange(1, 9, dtype=torch.int64)[None]
    assert ref.rotate(p, torch.tensor([8])).tolist() == [[(-v) & ref.MASK32 for v in range(1, 9)]]
    assert ref.rotate(p, torch.tensor([16])).tolist() == p.tolist()
    # X * (1 + 2X + ... + 8X^7) = -8 + X + 2X^2 + ...
    assert ref.rotate(p, torch.tensor([1])).tolist() == [[(-8) & ref.MASK32, 1, 2, 3, 4, 5, 6, 7]]


def test_modswitch_rounds_to_nearest():
    N = 64                                  # 2N = 128: one unit is 2^25
    x = torch.tensor([0, (1 << 24) - 1, 1 << 24, 3 << 25, (1 << 32) - 1])
    assert ref.modswitch(x, N).tolist() == [0, 0, 1, 3, 0]


@pytest.mark.parametrize("lat", [TOY, TOY_K2], ids=["k1", "k2"])
def test_gadget_digits_recompose_to_l_bgbit_bits(lat):
    x = torch.randint(0, 1 << 32, (50,), generator=torch.Generator().manual_seed(1))
    d = ref.gadget_digits(lat, x[:, None])[:, :, 0]             # (50, l)
    assert int(d.min()) >= -(1 << (lat.bgbit - 1)) and int(d.max()) < 1 << (lat.bgbit - 1)
    back = sum(d[:, p] << (32 - (p + 1) * lat.bgbit) for p in range(lat.l)) & ref.MASK32
    err = ref.signed((back - x) & ref.MASK32).abs()
    assert int(err.max()) <= 1 << (32 - lat.l * lat.bgbit - 1)


def test_round_to_limbs_keeps_the_top_bytes_rounded():
    x = torch.tensor([0x12345678, 0x123456FF, 0x12345680, 0xFFFFFF80])
    assert ref.round_to_limbs(x, 3).tolist() == [0x12345600, 0x12345700, 0x12345700, 0]
    assert ref.round_to_limbs(x, 4).tolist() == [v & ref.MASK32 for v in x.tolist()]


@pytest.mark.parametrize("lat", [TOY, TOY_K2], ids=["k1", "k2"])
def test_gates_and_mux_on_every_input(lat):
    keys = material.make_keys(lat, material.generator("cpu", 5))
    gen = material.generator("cpu", 6)
    a_bits = torch.tensor([0, 0, 1, 1])
    b_bits = torch.tensor([0, 1, 0, 1])
    a = material.encrypt_bits(lat, keys, gen, a_bits)
    b = material.encrypt_bits(lat, keys, gen, b_bits)
    assert ref.decrypt_bits(keys, *a).tolist() == a_bits.tolist()
    key = ref.bootstrapping_key(lat, keys.bk)
    for name, (_, _, _, fn) in ref.GATES.items():
        out = ref.gate(lat, keys, name, a, b, key)
        assert ref.decrypt_bits(keys, *out).tolist() == fn(a_bits, b_bits).tolist(), name
        assert all(abs(int(ph) - ref.MU_1_8 * (2 * bit - 1)) < 1 << 26 for ph, bit in
                   zip(ref.phase(keys, *out), fn(a_bits, b_bits)))
    c = material.encrypt_bits(lat, keys, gen, 1 - b_bits)
    out = ref.mux(lat, keys, a, b, c, key)
    want = torch.where(a_bits == 1, b_bits, 1 - b_bits)
    assert ref.decrypt_bits(keys, *out).tolist() == want.tolist()


def test_control_differs_from_the_reference():
    keys = material.make_keys(TOY_K2, material.generator("cpu", 7))
    a = material.encrypt_bits(TOY_K2, keys, material.generator("cpu", 8), torch.tensor([0, 1] * 4))
    exact = ref.gate(TOY_K2, keys, "AND", a, a)
    low = ref.gate(TOY_K2.with_body_limbs(2), keys, "AND", a, a)
    assert (exact[1] != low[1]).all()
    assert ref.decrypt_bits(keys, *low).tolist() == ref.decrypt_bits(keys, *exact).tolist()


def test_sample_extract_and_keyswitch_keep_the_phase():
    lat = TOY_K2
    keys = material.make_keys(lat, material.generator("cpu", 9))
    msg = torch.tensor([1 << 29, -(1 << 29), 1 << 30, 0]) & ref.MASK32
    # A trivial accumulator with the message on the constant coefficient,
    # its mask random: the extracted sample decrypts to it under the ring key.
    acc = torch.randint(0, 1 << 32, (4, lat.k + 1, lat.N), generator=torch.Generator().manual_seed(3))
    body = ref.key_product(keys.tlwe_key, acc[:, :lat.k])
    acc[:, lat.k] = body
    acc[:, lat.k, 0] = (body[:, 0] + msg) & ref.MASK32
    a, b = ref.sample_extract(lat, acc)
    ring = (b - ref.dot_key(a, keys.tlwe_key.reshape(-1))) & ref.MASK32
    assert ring.tolist() == msg.tolist()
    sa, sb = ref.keyswitch(lat, keys.ks, a, b)
    err = ref.signed((ref.u32(sb) - ref.dot_key(sa, keys.lwe_key) - msg) & ref.MASK32).abs()
    assert int(err.max()) < 1 << 24


def test_peba1_distance_and_its_template_zero_quirk():
    # |p - t| per slot, squares summed ...
    assert peba1.distance([10, 20], [13, 16], 8) == 9 + 16
    # ... except a template slot of 0, which gives 2^bitsize - p (low bits).
    assert peba1.distance([0], [5], 8) == 251 ** 2
    assert peba1.distance([0], [0], 8) == 0
    # The sum wraps at 3*bitsize - 1 bits.
    assert peba1.distance([0] * 6, [1] * 6, 3) == 6 * 49 - 256


def test_peba1_decision_nonce_and_verdicts():
    t = np.array([[5, 5], [5, 5], [5, 5]])
    p = np.array([[5, 7], [5, 9], [1, 9]])          # distances 4, 16, 32 vs bound 16
    b = peba1.decision(t, p, 16, 8)
    assert b.tolist() == [0, 0, 1]
    assert peba1.decision_word(b, 8)[2].tolist() == [1] + [0] * 23
    y = peba1.blinded_nonce(b, np.array([3, 0, 9]), np.array([200, 201, 202]), 8)
    assert y.tolist() == [253, 0, 202]
    v = peba1.verdicts(y, np.array([200, 201, 202]))
    assert v["is_match"].tolist() == [True, True, False]
