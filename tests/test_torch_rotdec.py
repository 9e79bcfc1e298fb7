"""`rotate_decompose`'s plan, and a model of its kernel, on the CPU.

The kernel (``csrc/rotate_decompose.cu``) is a persistent grid from
`cuda_kernels.rotdec_plan`: block x takes rows x, x + blocks, ..., each
through a ring of shared-memory stages filled by bulk copies, its digits
staged per row and stored by one bulk copy.  It runs only on the card
(tests/test_torch_cuda.py, ``python3 chip_smoke.py``).  Here: the plan
covers every row once and fits the shared memory it claims, and a torch
model that computes the way the kernel does (lanes on consecutive
coefficients, one negation boundary per polynomial, digits staged per row)
equals the plain twin and the Pallas kernel in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import params as jparams
from peba1_tpu.ops import pallas_kernels as pk
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.ops import decompose as dec
from peba1_tpu_torch.params import PRESETS, TOY, TOY_FAST, TOY_T2

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores.
torch.set_num_threads(1)

THREADS = 256                  # the kernel's block: the lanes of one pass
MASK = (1 << 32) - 1
BATCHES = (1, 67, 184, 760, 1000, 2048, 8192)
KERNEL_PRESETS = sorted(name for name, p in PRESETS.items()
                        if p.use_pallas_rotate or p.use_pallas_extprod)


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", ["peba1_128_t2", "peba1_128_fast"])
def test_plan_covers_every_row_once(name, B, sm_count):
    plan = ck.rotdec_plan(B, PRESETS[name], sm_count)
    rows = [b for x in range(plan.blocks) for b in plan.rows_of(x)]
    assert sorted(rows) == list(range(B))
    assert all(plan.rows_of(x) for x in range(plan.blocks))         # no idle block
    per_sm = min(ck.ROTDEC_BLOCKS_PER_SM,
                 ck.SM_SHARED_BYTES // (plan.smem + ck.BLOCK_RESERVED))
    assert plan.blocks == min(B, per_sm * sm_count)


@pytest.mark.parametrize("name", KERNEL_PRESETS)
def test_plan_ring_fits_and_bulk_copies_are_whole_16_bytes(name):
    """Every preset that calls the kernel: whole-row copies that a bulk copy
    takes, a ring of at least four rows that fits in the shared memory the
    plan claims without the opt-in, and blocks that fit on an SM together."""
    p = PRESETS[name]
    plan = ck.rotdec_plan(8192, p, 132)
    assert plan.row_bytes == 4 * (p.k + 1) * p.N and plan.row_bytes % 16 == 0
    assert plan.digit_bytes == (p.k + 1) * p.l * p.N and plan.digit_bytes % 16 == 0
    assert plan.stages >= 4
    # the ring, two staged digit rows, an amt word and an mbarrier a stage
    assert plan.smem >= plan.stages * (plan.row_bytes + 4 + 8) + 2 * plan.digit_bytes
    assert plan.smem <= 48 * 1024
    per_sm = plan.blocks // 132
    assert per_sm >= 1 and per_sm * (plan.smem + ck.BLOCK_RESERVED) <= ck.SM_SHARED_BYTES


@pytest.mark.parametrize("N", [32, 16])
def test_kernel_refuses_an_n_it_cannot_take(N):
    """Rows of 4(k+1)N and (k+1)lN bytes need N % 64 == 0 to stay whole
    multiples of 16 bytes at every k and l."""
    with pytest.raises(ValueError):
        ck.rotdec_plan(8, dataclasses.replace(TOY, N=N), 132)


def kernel_model(acc_flat: torch.Tensor, amt: torch.Tensor, p, plan) -> torch.Tensor:
    """The digits as ``csrc/rotate_decompose.cu`` computes them: each block
    walks its rows through a ring of `plan.stages` stages (a row and its amt
    arrive together), lanes take consecutive coefficients c = u*N + t, read
    the row plainly at c and rotated at i = (t - a) mod 2N (negated where
    i >= N), and write digit q of each as a byte into the row's staging
    buffer (two, alternating), which is then stored whole.  uint32
    arithmetic in int64 under a 32-bit mask."""
    N, k1, l = p.N, p.k + 1, p.l
    log_n, kn = N.bit_length() - 1, k1 * N
    offset, bg_mask, half_bg = dec.gadget_offset(p), (1 << p.bgbit) - 1, 1 << (p.bgbit - 1)
    acc = acc_flat.to(torch.int64) & MASK
    out = torch.zeros((plan.rows, plan.digit_bytes), dtype=torch.int8)
    for block in range(plan.blocks):
        rows = plan.rows_of(block)
        ring = torch.zeros((plan.stages, kn), dtype=torch.int64)
        amt_slots = [0] * plan.stages
        staging = torch.zeros((2, plan.digit_bytes), dtype=torch.int8)

        def load(j):
            ring[j % plan.stages] = acc[rows[j]]
            amt_slots[j % plan.stages] = int(amt[rows[j]])

        for j in range(min(plan.stages, len(rows))):
            load(j)
        for j, b in enumerate(rows):
            row, a, buf = ring[j % plan.stages], amt_slots[j % plan.stages], staging[j & 1]
            for c0 in range(0, kn, THREADS):
                c = torch.arange(c0, min(c0 + THREADS, kn))
                u, t = c >> log_n, c & (N - 1)
                i = (t - a) & (2 * N - 1)
                x = row[(u << log_n) + (i & (N - 1))]
                v = (torch.where(i < N, x, -x) - row[c] + offset) & MASK
                for q in range(l):
                    buf[u * l * N + q * N + t] = (
                        ((v >> (32 - (q + 1) * p.bgbit)) & bg_mask) - half_bg).to(torch.int8)
            out[b] = buf
            if j + plan.stages < len(rows):
                load(j + plan.stages)
    return out


def pallas(acc: np.ndarray, amt: np.ndarray, name: str) -> np.ndarray:
    jp = getattr(jparams, name)
    return np.asarray(pk.rotate_decompose(jnp.asarray(acc), jnp.asarray(amt), jp,
                                          interpret=True))


@pytest.mark.parametrize("sm_count", [7, 132])
@pytest.mark.parametrize("name,p", [("TOY", TOY), ("TOY_FAST", TOY_FAST), ("TOY_T2", TOY_T2)])
def test_kernel_model_at_every_rotation(name, p, sm_count):
    """Row b rotated by b, for every amt in [0, 2N).  With 7 SMs each block
    walks 9-10 rows through its 4 stages, so the ring wraps; with 132, each
    block takes one row."""
    B = 2 * p.N
    rng = np.random.default_rng(21)
    acc = rng.integers(-2**31, 2**31, (B, (p.k + 1) * p.N), dtype=np.int64).astype(np.int32)
    amt = np.arange(B, dtype=np.int32)
    plan = ck.rotdec_plan(B, p, sm_count)
    assert (len(plan.rows_of(0)) > plan.stages) == (sm_count == 7)
    got = kernel_model(torch.as_tensor(acc), torch.as_tensor(amt), p, plan)
    want = ck.rotate_decompose_plain(torch.as_tensor(acc), torch.as_tensor(amt), p)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), pallas(acc, amt, name))


@pytest.mark.parametrize("name", ["PEBA1_128_T2", "PEBA1_128_FAST"])
def test_kernel_model_at_full_width(name):
    """The real N (512 at t2, 1024 at fast) on six rows: no shift, one, the
    last shift below N, the negation, one past it and the last, on acc
    holding the extremes of int32 at each polynomial's ends."""
    p = PRESETS[name.lower()]
    N = p.N
    amt = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1], dtype=np.int32)
    rng = np.random.default_rng(22)
    acc = rng.integers(-2**31, 2**31, (6, (p.k + 1) * N), dtype=np.int64).astype(np.int32)
    for u in range(p.k + 1):
        acc[:, u * N:u * N + 4] = [-2**31, 2**31 - 1, 0, -1]
        acc[:, (u + 1) * N - 4:(u + 1) * N] = [-1, 0, 2**31 - 1, -2**31]
    plan = ck.rotdec_plan(6, p, 1)                  # 4 blocks: two take two rows
    got = kernel_model(torch.as_tensor(acc), torch.as_tensor(amt), p, plan)
    want = ck.rotate_decompose_plain(torch.as_tensor(acc), torch.as_tensor(amt), p)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), pallas(acc, amt, name))
