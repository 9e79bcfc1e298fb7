"""The A-matrix and conv forms of the key, and the plain twin of the
fused_blind_rotate kernel, against peba1_tpu.

Inputs are made from a seed with numpy and handed to both packages; every
integer result must be equal.  The coarse shift (U-1-u)K of the A-matrix is
invisible at U = N/K = 1, so each check also runs at U = 2.  The fused
kernel's Pallas reference runs in interpret mode, as tests/test_fused.py runs
it, over a few steps.  The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py and `python3 chip_smoke.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu.ops import pallas_kernels as pk
from peba1_tpu.ops import poly as jpoly
from peba1_tpu.params import TOY, TOY_FAST, TOY_T2
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.ops import poly

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

# name -> (params, amat_block): U = N / min(block, N)
GEOMETRY = {"n128_u1": (TOY_FAST, 128),
            "n256_u2": (dataclasses.replace(TOY_FAST, N=256), 128),
            "n512_k256_u2": (dataclasses.replace(TOY_FAST, N=512, amat_block=256), 256)}
FUSED = {"toy": TOY, "toy_fast": TOY_FAST, "toy_t2": TOY_T2,
         "toy_fast_n256": dataclasses.replace(TOY_FAST, N=256)}
STEPS = 3
BATCH = 11
MU = -(1 << 29) + 12345
# The reference's A-matrix functions, compiled once (eager, each of their K
# slices is a separate dispatch).
prepare_amat = jax.jit(jpoly.prepare_amat, static_argnames="block")
extprod_amat_i8 = jax.jit(jpoly.extprod_amat_i8, static_argnames=("limbs", "N"))


def generator(p, steps, seed):
    """A random doubled limb generator (CloudKey.bk_tp's form), with a row
    of -128 limbs."""
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    vv = np.random.default_rng(seed).integers(-128, 128, (steps, G, C, 2 * p.N))
    vv[0, 0, 0, :] = -128
    return vv.astype(np.int8)


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_prepare_amat_is_the_transpose_of_jax(name):
    p, block = GEOMETRY[name]
    vv = generator(p, STEPS, 1)
    want = np.asarray(prepare_amat(jnp.asarray(vv), block=block))
    got = poly.prepare_amat(torch.as_tensor(vv), block, chunk=2)   # a ragged chunk
    assert got.shape[-1] == min(block, p.N)
    np.testing.assert_array_equal(got.transpose(-1, -2).numpy(), want)


def random_digits(p, seed):
    d = np.random.default_rng(seed).integers(-p.half_bg, p.half_bg,
                                             (BATCH, (p.k + 1) * p.l, p.N))
    d[0, 0, :] = -p.half_bg
    return d.astype(np.int8)


PLANS = pytest.mark.parametrize("k,plan", [(1, (4, 3)), (2, (4, 4, 3))], ids=["k1", "k2"])


@pytest.mark.parametrize("name", ["n128_u1", "n256_u2"])
@PLANS
def test_extprod_amat_equals_jax(name, k, plan):
    """One random key step and random digits, the port's A-matrix layout."""
    base, block = GEOMETRY[name]
    p = dataclasses.replace(base, k=k)
    assert p.limb_plan == plan
    d = random_digits(p, 2)
    a = np.asarray(prepare_amat(jnp.asarray(generator(p, 1, 3)), block=block))[0]
    want = extprod_amat_i8(jnp.asarray(d), jnp.asarray(a), limbs=plan, N=p.N)
    got = poly.extprod_amat_i8(torch.as_tensor(d), torch.tensor(a).transpose(-1, -2),
                               plan, p.N)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@PLANS
def test_negacyclic_conv_equals_jax(k, plan):
    """The conv form of a random TRGSW step, and the product against it."""
    p = dataclasses.replace(TOY_FAST, k=k, N=256)
    assert p.limb_plan == plan
    G = (k + 1) * p.l
    d = random_digits(p, 4)
    q = np.random.default_rng(5).integers(-2**31, 2**31, (G, k + 1, p.N), dtype=np.int64)
    q[0, 0, :4] = [-2**31, 2**31 - 1, 0, -128]
    q = q.astype(np.int32)
    rhs = np.asarray(jpoly.prepare_conv_rhs(jnp.asarray(q), plan))
    np.testing.assert_array_equal(
        rhs, poly.prepare_conv_rhs(torch.as_tensor(q), plan).numpy())
    want = jpoly.negacyclic_conv_i8(jnp.asarray(d), jnp.asarray(rhs), plan)
    got = poly.negacyclic_conv_i8(torch.as_tensor(d), torch.tensor(rhs), plan)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", sorted(FUSED))
def test_plain_fused_blind_rotate_matches_pallas(name):
    """The wrapper on CPU tensors (its plain twin) against the Pallas kernel
    in interpret mode on the same amt, JAX-layout A-matrix and mu; amt is
    (B, n+1) in JAX and (n+1, B) in the port."""
    p = FUSED[name]
    vv = generator(p, STEPS, 4)
    ja = prepare_amat(jnp.asarray(vv), block=p.amat_block)
    amt = np.random.default_rng(5).integers(0, 2 * p.N, (STEPS + 1, BATCH)).astype(np.int32)
    amt[:, :3] = [0, p.N, 2 * p.N - 1]
    want = pk.fused_blind_rotate(jnp.asarray(amt.T), ja, jnp.int32(MU), p, interpret=True)
    ta = torch.tensor(np.asarray(ja)).transpose(-1, -2).contiguous()
    before = dict(ck.launches)
    got = ck.fused_blind_rotate(torch.as_tensor(amt), ta, MU, p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert ck.launches == before            # the CPU path launches nothing


@pytest.mark.parametrize("bad", ["span", "block", "dtype", "steps"])
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p = FUSED["toy_fast_n256"]
    amat = poly.prepare_amat(torch.as_tensor(generator(p, 2, 6)), 128)
    amt = torch.zeros((3, 4), dtype=torch.int32)
    if bad == "span":
        amat = amat[..., :-1, :].contiguous()
    elif bad == "block":
        amat = amat[..., :96].contiguous()            # K = 96 does not divide N
    elif bad == "dtype":
        amat = amat.to(torch.int16)
    else:
        amt = amt[:2]
    with pytest.raises(ValueError):
        ck.fused_blind_rotate(amt, amat, MU, p)
