"""Tests of the port that need the card (marker `cuda`; they skip elsewhere).

This file imports neither jax nor peba1_tpu, so it also runs where only the
port is installed.  On the card, without the jax-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from peba1_tpu_torch import gates, keys, lwe
from peba1_tpu_torch.ops import bootstrap as bs
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.params import PRESETS, TOY, TOY_FAST, TOY_T2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda", 0)


def random_step_inputs(p, B, steps, seed, device):
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    rng = np.random.default_rng(seed)
    acc = rng.integers(-2**31, 2**31, (B, (p.k + 1) * p.N), dtype=np.int64)
    acc[0, :4] = [-2**31, 2**31 - 1, 0, -1]
    amt = rng.integers(0, 2 * p.N, (steps, B)).astype(np.int32)
    vv = rng.integers(-128, 128, (steps, G, C, 2 * p.N)).astype(np.int8)
    vv[:, 0, 0, :] = -128
    return (torch.as_tensor(acc.astype(np.int32), device=device),
            torch.as_tensor(amt, device=device), torch.as_tensor(vv, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", [("peba1_128_t2_gen", 1000), ("peba1_128_fast_gen", 64),
                                    ("ring_2048_gen", 67)])
def test_kernel_matches_plain(cuda_device, name, B):
    p = PRESETS[name]
    acc, amt, vv = random_step_inputs(p, B, 2, 4, cuda_device)
    want = ck.cmux_step_gen_plain(acc.clone(), amt, vv, p)
    before = ck.launches["cmux_step_gen"]
    got = ck.cmux_step_gen(acc.clone(), amt, vv, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["cmux_step_gen"] == before + 2 * 2   # 2 steps, 2 kernels each


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,steps", [
    ("peba1_128_fast_genf", 1000, 3), ("peba1_128_t2_genf", 67, 2)])
def test_blind_rotate_gen_full_matches_plain(cuda_device, name, B, steps):
    """One launch for the whole rotation; a batch above one 64-row tile, so
    a missing grid barrier would show."""
    p = PRESETS[name]
    _, amt, vv = random_step_inputs(p, B, steps + 1, 5, cuda_device)
    vv = vv[:steps].contiguous()
    mu = -(1 << 29) + 7
    want = ck.blind_rotate_gen_full_plain(amt, vv, mu, p)
    before = ck.launches["blind_rotate_gen_full"]
    got = ck.blind_rotate_gen_full(amt, vv, mu, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["blind_rotate_gen_full"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rotate_decompose", "extprod_recombine", "cmux_step"])
@pytest.mark.parametrize("name,B", [("peba1_128_t2", 1000), ("peba1_128_fast", 67)])
def test_w_kernels_match_plain(cuda_device, kernel, name, B):
    """The precomputed-weight family on random acc, amt and W (the port's
    (C*N, G*N) layout): every output polynomial, o < k and o = k."""
    p = PRESETS[name]
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    acc, amt, _ = random_step_inputs(p, B, 2, 6, cuda_device)
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.integers(-128, 128, (2, C * p.N, G * p.N)).astype(np.int8),
                        device=cuda_device)
    d = torch.as_tensor(rng.integers(-p.half_bg, p.half_bg, (B, G * p.N)).astype(np.int8),
                        device=cuda_device)
    args = {"rotate_decompose": (acc, amt[0]), "extprod_recombine": (d, w[0]),
            "cmux_step": (acc, amt, w)}[kernel]
    want = getattr(ck, kernel + "_plain")(*[a.clone() for a in args], p)
    before = ck.launches[kernel]
    got = getattr(ck, kernel)(*[a.clone() for a in args], p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches[kernel] == before + (4 if kernel == "cmux_step" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["peba1_128_t2", "peba1_128_fast", "peba1_128_t2_genf"])
def test_unported_kernels_raise(cuda_device, name):
    """Only use_fused_cmux, which no preset sets, still raises on the card."""
    p = dataclasses.replace(PRESETS[name], use_fused_cmux=True)
    bara = torch.zeros((2, p.n), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="fused_blind_rotate"):
        bs.blind_rotate(_NoKey(p), bara, bara[:, 0], 1)


class _NoKey:
    """A stand-in cloud key: blind_rotate must raise before reading a key."""

    def __init__(self, params):
        self.params = params


@pytest.mark.cuda
@pytest.mark.parametrize("p", [
    dataclasses.replace(TOY_T2, use_gen_step=True),
    dataclasses.replace(TOY, N=256, use_gen_step=True),
    TOY_FAST, TOY_T2, dataclasses.replace(TOY_T2, w_streaming=True),
    dataclasses.replace(TOY_FAST, use_gen_step=True, use_gen_full=True),
    dataclasses.replace(TOY_T2, use_fused_step=False, use_pallas_extprod=True)],
    ids=["toy_t2_gen", "toy_n256_gen", "toy_fast", "toy_t2", "toy_t2_stream",
         "toy_fast_genf", "toy_t2_extprod"])
def test_bootstrap_on_the_card_equals_the_cpu(cuda_device, p):
    """The same key and ciphertext tensors: the kernel path on the card and
    the plain path on the CPU give the same bits."""
    sk, cpu_key = keys.keygen(torch.Generator().manual_seed(1), p, "cpu")
    gpu_key = keys.CloudKey(bk_tp=cpu_key.bk_tp.to(cuda_device),
                            ks_table_limbs=cpu_key.ks_table_limbs.to(cuda_device),
                            params=p, bk_w=None if cpu_key.bk_w is None
                            else cpu_key.bk_w.to(cuda_device))
    bits = np.arange(77) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(2), sk, bits)
    pre = lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8)
    want = bs.bootstrap(cpu_key, pre, gates.MU_1_8)
    got = bs.bootstrap(gpu_key, lwe.Lwe(pre.a.to(cuda_device), pre.b.to(cuda_device)),
                       gates.MU_1_8)
    assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b)
    np.testing.assert_array_equal(gates.decrypt_bits(want, sk).numpy(), bits)
