"""The port's exact negacyclic NTT (ops/ntt.py) against peba1_tpu.ops.ntt and
the naive product, bit for bit (the cases of tests/test_ntt.py)."""

import jax
import numpy as np
import pytest
import torch

from peba1_tpu.ops import ntt as jntt
from peba1_tpu_torch.ops import ntt, poly

torch.set_num_threads(1)


@pytest.mark.parametrize("N", [128, 512, 2048])
def test_ntt_roundtrip_and_transform_match_jax(N):
    rng = np.random.default_rng(N)
    x = rng.integers(-(1 << 20), 1 << 20, (3, N)).astype(np.int32)
    X = ntt.ntt_negacyclic(torch.as_tensor(x))
    want = np.asarray(jax.jit(jntt.ntt_negacyclic)(x)).astype(np.int64)
    np.testing.assert_array_equal(X.numpy(), want)
    np.testing.assert_array_equal(ntt.intt_negacyclic(X).numpy(), x)


@pytest.mark.parametrize("N", [128, 512, 2048])
def test_negacyclic_mul_exact_matches_jax_and_naive(N):
    """Digit x key-limb shaped inputs (the external product's): equal to
    JAX's NTT product and to ops/poly.negacyclic_mul_naive."""
    rng = np.random.default_rng(N + 1)
    a = rng.integers(-128, 128, (2, N)).astype(np.int32)   # gadget digits
    b = rng.integers(-128, 128, (2, N)).astype(np.int32)   # int8 key limbs
    got = ntt.negacyclic_mul_exact(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jntt.negacyclic_mul_exact)(a, b)))
    np.testing.assert_array_equal(
        got, poly.negacyclic_mul_naive(torch.as_tensor(a), torch.as_tensor(b)).numpy())


def test_ntt_mul_vs_toeplitz_column():
    """A second oracle: the product's coefficients as the columns of the
    negacyclic Toeplitz matrix of b (ops/poly.negacyclic_toeplitz_cols on
    the doubled generator), dotted with a in exact int64."""
    N = 256
    rng = np.random.default_rng(9)
    a = rng.integers(-128, 128, (1, N)).astype(np.int32)
    b = rng.integers(-128, 128, (1, N)).astype(np.int32)
    got = ntt.negacyclic_mul_exact(torch.as_tensor(a), torch.as_tensor(b))[0]
    # W[t, j] = coefficient j of X^t * b, so (a * b)_j = sum_t a_t W[t, j].
    vv = poly.doubled_neg(torch.as_tensor(b[0]))
    for j0 in (0, N // 2):
        W = poly.negacyclic_toeplitz_cols(vv, j0, N // 2).to(torch.int64)
        want = torch.as_tensor(a[0], dtype=torch.int64) @ W
        np.testing.assert_array_equal(got[j0:j0 + N // 2].numpy(), want.numpy())


@pytest.mark.parametrize("N", [3, 96, 1 << 25])
def test_tables_reject_unsupported_ring_sizes(N):
    with pytest.raises(ValueError, match="not a power of two with 2N"):
        ntt._tables(N)
