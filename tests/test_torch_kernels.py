"""The CUDA kernels' plain twins against the Pallas kernels, and the
wrappers' contract.

On the CPU a wrapper runs its plain twin; the Pallas reference runs in
interpret mode, as tests/test_fused.py runs it.  Inputs are made from a seed
with numpy, at a batch that is not a power of two, and every result must be
equal.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py and `python3 chip_smoke.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu.ops import pallas_kernels as pk
from peba1_tpu.ops import poly as jpoly
from peba1_tpu.params import TOY, TOY_FAST, TOY_T2
from peba1_tpu_torch import keys
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.ops import poly

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

GEN = {"toy_t2": dataclasses.replace(TOY_T2, use_gen_step=True),
       "toy_n256": dataclasses.replace(TOY, N=256, use_gen_step=True)}
W_PARAMS = {"toy_fast": TOY_FAST, "toy_t2": TOY_T2,
            "toy_n256": dataclasses.replace(TOY, N=256)}
BATCH = 13
STEPS = 4


@pytest.fixture(scope="module", params=sorted(W_PARAMS))
def w_key(request):
    """A random 4-step generator (CloudKey.bk_tp's form), JAX's bk_w of it
    (peba1_tpu.ops.poly.prepare_w_full), and both carried into the port."""
    p = W_PARAMS[request.param]
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    vv = np.random.default_rng(4).integers(-128, 128, (STEPS, G, C, 2 * p.N)).astype(np.int8)
    vv[0, 0, 0, :] = -128
    jvv = jnp.asarray(vv)
    jw = jpoly.prepare_w_full(jvv)
    tw = keys.cloud_key_from_numpy(dataclasses.replace(p, n=STEPS, use_pallas_extprod=True),
                                   vv,
                                   np.zeros((p.k * p.N * p.ks_t, (STEPS + 1) * 4), np.int8),
                                   "cpu", bk_w=np.asarray(jw)).bk_w
    return p, jvv, jw, torch.as_tensor(vv), tw


def random_step_inputs(p, B, steps, seed):
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    rng = np.random.default_rng(seed)
    acc = rng.integers(-2**31, 2**31, (B, (p.k + 1) * p.N), dtype=np.int64)
    acc[0, :4] = [-2**31, 2**31 - 1, 0, -1]
    amt = rng.integers(0, 2 * p.N, (steps, B)).astype(np.int32)
    amt[:, :3] = [0, p.N, 2 * p.N - 1]
    vv = rng.integers(-128, 128, (steps, G, C, 2 * p.N)).astype(np.int8)
    vv[:, 0, 0, :] = -128
    return acc.astype(np.int32), amt, vv


def test_port_bk_w_is_the_transpose_of_prepare_w_full(w_key):
    _, _, jw, vv, tw = w_key
    built = poly.prepare_w_full(vv, chunk=3)                  # a ragged last chunk
    np.testing.assert_array_equal(built.transpose(1, 2).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tw.numpy(), built.numpy())  # JAX's, carried
    np.testing.assert_array_equal(poly.toeplitz_weights(vv[1]).numpy(), built[1].numpy())


def test_plain_rotate_decompose_matches_pallas(w_key):
    """Natural digit order on random acc (no symmetry in t)."""
    p = w_key[0]
    acc, amt, _ = random_step_inputs(p, BATCH, 3, seed=5)
    want = pk.rotate_decompose(jnp.asarray(acc), jnp.asarray(amt[0]), p, interpret=True)
    got = ck.rotate_decompose(torch.as_tensor(acc), torch.as_tensor(amt[0]), p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_plain_extprod_recombine_matches_pallas(w_key):
    p, _, jw, _, tw = w_key
    G = (p.k + 1) * p.l
    d = np.random.default_rng(6).integers(-p.half_bg, p.half_bg, (BATCH, G * p.N))
    d = d.astype(np.int8)
    for s in (0, STEPS - 1):
        want = pk.extprod_recombine(jnp.asarray(d), jw[s], p, interpret=True)
        got = ck.extprod_recombine(torch.as_tensor(d), tw[s], p)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_plain_cmux_step_matches_pallas(w_key):
    """Two chained steps against JAX's bk_w, carried across."""
    p, _, jw, _, tw = w_key
    acc, amt, _ = random_step_inputs(p, BATCH, 3, seed=7)
    want = jnp.asarray(acc)
    for s in range(2):
        want = pk.cmux_step(want, jnp.asarray(amt[s]), jw[s], p, interpret=True)
    got = ck.cmux_step(torch.as_tensor(acc.copy()), torch.as_tensor(amt[:2]), tw[:2], p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_plain_blind_rotate_gen_full_matches_pallas(w_key):
    """The whole rotation with vv cut to 3 steps; amt is (B, n+1) in JAX and
    (n+1, B) in the port."""
    p, jvv, _, vv, _ = w_key
    amt = np.random.default_rng(8).integers(0, 2 * p.N, (4, BATCH)).astype(np.int32)
    mu = -(1 << 29) + 12345
    want = pk.blind_rotate_gen_full(jnp.asarray(amt.T), jvv[:3], jnp.int32(mu), p,
                                    interpret=True)
    got = ck.blind_rotate_gen_full(torch.as_tensor(amt), vv[:3], mu, p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", sorted(GEN))
def test_plain_cmux_step_gen_matches_pallas(name):
    """Two chained steps at a batch that is not a power of two."""
    p = GEN[name]
    acc, amt, vv = random_step_inputs(p, 13, 2, seed=1)
    want = jnp.asarray(acc)
    for s in range(2):
        want = pk.cmux_step_gen(want, jnp.asarray(amt[s]), jnp.asarray(vv[s]), p,
                                interpret=True)
    got = ck.cmux_step_gen(torch.as_tensor(acc.copy()), torch.as_tensor(amt),
                           torch.as_tensor(vv), p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_wrapper_updates_in_place_and_counts_no_cpu_launch():
    p = GEN["toy_t2"]
    acc, amt, vv = random_step_inputs(p, 5, 1, seed=2)
    t = torch.as_tensor(acc.copy())
    before = dict(ck.launches)
    out = ck.cmux_step_gen(t, torch.as_tensor(amt), torch.as_tensor(vv), p)
    assert out is t and not np.array_equal(t.numpy(), acc)
    assert ck.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p = GEN["toy_t2"]
    acc, amt, vv = (torch.as_tensor(x) for x in random_step_inputs(p, 4, 1, seed=3))
    if bad == "dtype":
        acc = acc.to(torch.int64)
    elif bad == "shape":
        vv = vv[:, :-1].contiguous()
    elif bad == "layout":
        acc = acc.t().contiguous().t()
    else:
        acc, amt, vv = (x.to("meta") for x in (acc, amt, vv))
    with pytest.raises(ValueError):
        ck.cmux_step_gen(acc, amt, vv, p)

