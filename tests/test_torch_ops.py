"""Bit-exact checks of the port's torus and ring primitives against peba1_tpu.

Inputs are made from a seed with numpy, handed to both packages, and every
integer result must be equal (no tolerance).  The random int32 inputs always
include -2^31, 2^31-1, 0 and values whose balanced limbs are -128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import tlwe as jtlwe
from peba1_tpu.ops import bootstrap as jbs
from peba1_tpu.ops import decompose as jdec
from peba1_tpu.ops import poly as jpoly
from peba1_tpu.ops import rotate as jrot
from peba1_tpu.params import TOY, TOY_T2
from peba1_tpu_torch import keys as tkeys
from peba1_tpu_torch import tlwe as ttlwe
from peba1_tpu_torch import torus as ttorus
from peba1_tpu_torch.ops import bootstrap as tbs
from peba1_tpu_torch.ops import decompose as tdec
from peba1_tpu_torch.ops import poly as tpoly
from peba1_tpu_torch.ops import rotate as trot
from peba1_tpu_torch.params import PRESETS

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

EXTREMES = np.array([-2**31, 2**31 - 1, 0, -1, 128, -128, 0x8080, 0x7F7F7F80,
                     -2139062144, 0x80, 2**31 - 128, -2**31 + 128], np.int64)
PARAMS = {"toy": TOY, "toy_t2": TOY_T2, "ring_2048": PRESETS["ring_2048"]}


def rand_i32(seed, shape):
    """Random int32 with the EXTREMES planted at the front."""
    x = np.random.default_rng(seed).integers(-2**31, 2**31, shape, dtype=np.int64)
    flat = x.reshape(-1)
    m = min(flat.size, EXTREMES.size)
    flat[:m] = EXTREMES[:m]
    return flat.reshape(shape).astype(np.int32)


def eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.cpu().numpy())


@pytest.mark.parametrize("N", [128, 512, 2048])
def test_modswitch_2n(N):
    x = rand_i32(1, (64, 7))
    eq(jrot.modswitch_2n(jnp.asarray(x), N), trot.modswitch_2n(torch.as_tensor(x), N))


@pytest.mark.parametrize("N", [128, 256])
def test_negacyclic_rotate(N):
    x = rand_i32(2, (9, 3, N))
    amt = np.random.default_rng(3).integers(0, 2 * N, (9, 1)).astype(np.int32)
    amt[:4, 0] = [0, N, 2 * N - 1, N - 1]
    eq(jrot.negacyclic_rotate(jnp.asarray(x), jnp.asarray(amt)),
       trot.negacyclic_rotate(torch.as_tensor(x), torch.as_tensor(amt)))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_decompose_and_gadget_offset(name):
    p = PARAMS[name]
    assert tdec.gadget_offset(p) == jdec.gadget_offset(p)
    x = rand_i32(4, (5, 3, 64))
    eq(jdec.decompose(jnp.asarray(x), p), tdec.decompose(torch.as_tensor(x), p))


@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
def test_split_and_round_limbs(limbs):
    x = rand_i32(5, (6, 200))
    got = tpoly.split_limbs_i8(torch.as_tensor(x), limbs)
    eq(jpoly.split_limbs_i8(jnp.asarray(x), limbs), got)
    eq(jpoly.round_to_limbs(jnp.asarray(x), limbs),
       tpoly.round_to_limbs(torch.as_tensor(x), limbs))
    assert int(got.min()) == -128  # the extremes reach the -128 limb
    eq(jpoly.recombine_limbs_i32(jnp.asarray(got.numpy()).astype(jnp.int32), limbs),
       tpoly.recombine_limbs_i32(got.to(torch.int32), limbs))


@pytest.mark.parametrize("plan", [(4, 4), (4, 3), (4, 4, 3), (2, 1)])
def test_prepare_toeplitz_rhs(plan):
    q = rand_i32(6, (4, len(plan), 32))
    eq(jpoly.prepare_toeplitz_rhs(jnp.asarray(q), plan),
       tpoly.prepare_toeplitz_rhs(torch.as_tensor(q), plan))
    eq(jpoly.prepare_conv_rhs(jnp.asarray(q), plan),
       tpoly.prepare_conv_rhs(torch.as_tensor(q), plan))


@pytest.mark.parametrize("plan", [(4, 4), (4, 4, 3)])
def test_extprod_toeplitz_i8(plan):
    G, N, B = 4, 32, 11
    rng = np.random.default_rng(7)
    q = rand_i32(8, (G, len(plan), N))
    vv = np.array(jpoly.prepare_toeplitz_rhs(jnp.asarray(q), plan))
    d = rng.integers(-128, 128, (B, G, N)).astype(np.int8)
    d[0, 0, :] = -128
    want = jpoly.extprod_toeplitz_i8(jnp.asarray(d), jnp.asarray(vv), plan)
    got = tpoly.extprod_toeplitz_i8(torch.as_tensor(d), torch.as_tensor(vv), plan)
    eq(want, got)
    # and the exact oracle: round-to-limbs(q) convolved with the digits
    qr = np.stack([np.asarray(jpoly.round_to_limbs(jnp.asarray(q[:, o]), nl))
                   for o, nl in enumerate(plan)], axis=1)
    eq(jpoly.negacyclic_extproduct_reference(jnp.asarray(d.astype(np.int32)),
                                             jnp.asarray(qr)), got)


def test_negacyclic_products():
    N = 64
    p, q = rand_i32(9, (3, N)), rand_i32(10, (3, N))
    eq(jpoly.negacyclic_mul_naive(jnp.asarray(p), jnp.asarray(q)),
       tpoly.negacyclic_mul_naive(torch.as_tensor(p), torch.as_tensor(q)))
    key = np.random.default_rng(11).integers(0, 2, (2, N)).astype(np.int32)
    a = rand_i32(12, (5, 2, N))
    eq(jpoly.key_negacyclic_mul(jnp.asarray(key), jnp.asarray(a)),
       tpoly.key_negacyclic_mul(torch.as_tensor(key), torch.as_tensor(a)))
    lk = np.random.default_rng(13).integers(0, 2, (630,)).astype(np.int32)
    a = rand_i32(14, (7, 630))
    eq(jpoly.dot_key_i32(jnp.asarray(a), jnp.asarray(lk)),
       tpoly.dot_key_i32(torch.as_tensor(a), torch.as_tensor(lk)))


@pytest.mark.parametrize("k", [1, 2])
def test_sample_extract(k):
    ct = rand_i32(15, (6, k + 1, 32))
    ja, jb = jtlwe.sample_extract(jnp.asarray(ct))
    ta, tb = ttlwe.sample_extract(torch.as_tensor(ct))
    eq(ja, ta)
    eq(jb, tb)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_keyswitch_digits(name):
    p = PARAMS[name]
    a = rand_i32(16, (9, 96))
    eq(jbs.keyswitch_digits(p, jnp.asarray(a)), tbs.keyswitch_digits(p, torch.as_tensor(a)))


def test_keyswitch_with_carried_key(toy_keys):
    _, ck = toy_keys
    tck = tkeys.cloud_key_from_numpy(TOY, np.array(ck.bk_tp),
                                     np.array(ck.ks_table_limbs), "cpu")
    a, b = rand_i32(17, (13, TOY.big_n)), rand_i32(18, (13,))
    want = jbs.keyswitch(ck, jnp.asarray(a), jnp.asarray(b))
    got = tbs.keyswitch(tck, torch.as_tensor(a), torch.as_tensor(b))
    eq(want.a, got.a)
    eq(want.b, got.b)


def test_torus_helpers():
    x = rand_i32(19, (300,))
    from peba1_tpu import torus as jt
    for msize in (4, 8, 256):
        eq(jt.approx_phase(jnp.asarray(x), msize), ttorus.approx_phase(torch.as_tensor(x), msize))
        for mu in range(msize):
            assert ttorus.modswitch_to_torus32(mu, msize) == jt.modswitch_to_torus32(mu, msize)


def test_torch_samplers_are_well_formed():
    """Fresh draws cannot match jax threefry: check range and spread only.
    Tolerances: the sample std of 20,000 gaussians is within 5% of stdev."""
    g = torch.Generator().manual_seed(0)
    u = ttorus.uniform_torus32(g, (20000,), "cpu")
    assert u.dtype == torch.int32 and int(u.min()) < -2**30 and int(u.max()) > 2**30
    stdev = 2.0**-15
    e = ttorus.gaussian_torus32(g, stdev, (20000,), "cpu").double()
    assert abs(float(e.std()) / (stdev * 2**32) - 1) < 0.05
    assert abs(float(e.mean())) < 0.05 * stdev * 2**32
    assert not ttorus.gaussian_torus32(g, 0.0, (5,), "cpu").any()


def test_plan_recombination_matches():
    cols = rand_i32(20, (3, 7, 16))
    plan = (4, 3)
    eq(jpoly.recombine_plan_i32(jnp.asarray(cols), plan),
       tpoly.recombine_plan_i32(torch.as_tensor(cols), plan))

