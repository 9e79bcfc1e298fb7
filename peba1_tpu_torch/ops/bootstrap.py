"""Batched gate bootstrapping: blind rotation + sample extract + key switch.

Counterpart of ``peba1_tpu/ops/bootstrap.py``:

  1. modswitch all phases to Z_2N;
  2. init accumulators = X^{-b_bar} * testvector;
  3. n CMUX steps: rotate, gadget-decompose, external product;
  4. sample extract;
  5. key switch as one digit-valued matmul.

Exact integer arithmetic throughout.  Step 3 follows the JAX package's
branch order (peba1_tpu/ops/bootstrap.py:69-174) on every device, each
branch through the wrapper in ``ops/cuda_kernels.py`` of the TPU kernel that
the JAX branch calls: the hand-written kernel on the card, its plain twin on
the CPU.
"""

from __future__ import annotations

import torch

from .. import lwe, tlwe
from ..params import TfheParams
from ..torus import MASK32, as_u32
from ..utils.device import from_host
from ..utils.logging import span, spanned
from . import cuda_kernels, poly, rotate


def selected_kernel(p: TfheParams) -> str | None:
    """The TPU kernel that runs `p`'s blind rotation in the JAX package's
    branch order (peba1_tpu/ops/bootstrap.py:69-149), or None for the plain
    scan of steps (which may call `rotate_decompose` and `extprod_recombine`
    per step, as its flags say)."""
    if p.use_fused_cmux:
        return "fused_blind_rotate"
    if p.use_gen_full:
        return "blind_rotate_gen_full"
    if p.use_gen_step:
        return "cmux_step_gen"
    if p.use_fused_step:
        return "cmux_step"
    return None


@spanned("rotation")
def blind_rotate(ck, bara: torch.Tensor, barb: torch.Tensor, mu: int) -> torch.Tensor:
    """Batched blind rotation of the all-mu testvector.

    bara: (B, n) int32 in [0, 2N); barb: (B,) int32 in [0, 2N); mu: torus32.
    Returns the (B, k+1, N) int32 accumulator ~ TRLWE(X^{-phase2N} * tv).
    """
    p = ck.params
    B = bara.shape[0]
    amt0 = (2 * p.N - barb) % (2 * p.N)
    amt = bara.T.contiguous()                          # (n, B), step-major
    kernel = selected_kernel(p)
    if kernel in ("fused_blind_rotate", "blind_rotate_gen_full"):
        amt_all = torch.cat([amt0[None].to(torch.int32), amt])
        key = ck.bk_amat if kernel == "fused_blind_rotate" else ck.bk_tp
        acc_flat = getattr(cuda_kernels, kernel)(amt_all, key, mu, p)
        return acc_flat.view(B, p.k + 1, p.N)

    with span("accumulator"):
        acc_flat = rotate.initial_accumulator(amt0, mu, p)
    acc = acc_flat.view(B, p.k + 1, p.N)
    if kernel == "cmux_step_gen":
        cuda_kernels.cmux_step_gen(acc_flat, amt, ck.bk_tp, p)     # in place
        return acc
    if kernel == "cmux_step":
        if p.w_streaming:
            # This step's W built from the generator outside the kernel, as
            # the JAX package builds it in the graph (one step at a time).
            for s in range(p.n):
                w = poly.toeplitz_weights(ck.bk_tp[s])[None]
                cuda_kernels.cmux_step(acc_flat, amt[s:s + 1], w, p)
        else:
            cuda_kernels.cmux_step(acc_flat, amt, ck.bk_w, p)
        return acc

    rotate_decompose = (cuda_kernels.rotate_decompose if p.use_pallas_rotate
                        else cuda_kernels.rotate_decompose_plain)
    backend = "pallas_extprod" if p.use_pallas_extprod else p.ext_backend
    for s in range(p.n):
        d = rotate_decompose(acc_flat, amt[s], p)                   # (B, G*N)
        if backend == "pallas_extprod":
            acc_flat += cuda_kernels.extprod_recombine(d, ck.bk_w[s], p)
            continue
        d = d.view(B, -1, p.N)
        if backend == "toeplitz":
            acc += poly.extprod_toeplitz_i8(d, ck.bk_tp[s], p.limb_plan)
        elif backend == "amat":
            acc += poly.extprod_amat_i8(d, ck.bk_amat[s], p.limb_plan, p.N)
        else:
            acc += poly.negacyclic_conv_i8(d, ck.bk_conv[s], p.limb_plan)
    return acc


def keyswitch_digits(p: TfheParams, a_ext: torch.Tensor) -> torch.Tensor:
    """Decompose extracted masks into base-2^basebit digit VALUES.

    a_ext: (B, kN) int32 -> (B, kN*t) int8 digits in [0, base).
    """
    B, kn = a_ext.shape
    u = (as_u32(a_ext) + (1 << (32 - (1 + p.ks_basebit * p.ks_t)))) & MASK32
    shifts = from_host([32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)],
                       torch.int64, a_ext.device)
    digits = (u[..., None] >> shifts) & (p.ks_base - 1)   # (B, kN, t)
    return digits.reshape(B, kn * p.ks_t).to(torch.int8)


@spanned("keyswitch")
def keyswitch(ck, a_ext: torch.Tensor, b_ext: torch.Tensor) -> lwe.Lwe:
    """Batched key switch kN -> n as a digit-valued matmul.

    The product runs in float64 (exact: |sum| <= kN*t*(base-1)*128 < 2^24).
    """
    p = ck.params
    B = a_ext.shape[0]
    digits = keyswitch_digits(p, a_ext)
    acc = poly.exact_matmul(digits, ck.ks_table_limbs)
    acc = poly.recombine_limbs_i32(acc.reshape(B, p.n + 1, 4), 4)   # (B, n+1)
    return lwe.Lwe(-acc[:, :p.n], b_ext - acc[:, p.n])


def bootstrap_wo_ks(ck, ct: lwe.Lwe, mu: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Bootstrap without the final key switch: the extracted (a, b) pair.

    ct: Lwe (B,) under the small key.  Output phase is +mu where phase(ct)
    is in (0, 1/2), -mu where it is in (-1/2, 0).
    """
    p = ck.params
    with span("modswitch"):
        bara = rotate.modswitch_2n(ct.a, p.N)
        barb = rotate.modswitch_2n(ct.b, p.N)
    acc = blind_rotate(ck, bara, barb, mu)
    with span("extract"):
        return tlwe.sample_extract(acc)


def bootstrap(ck, ct: lwe.Lwe, mu: int) -> lwe.Lwe:
    """Full gate bootstrap: LWE (B,) -> LWE (B,) with message +-mu by phase sign."""
    a_ext, b_ext = bootstrap_wo_ks(ck, ct, mu)
    return keyswitch(ck, a_ext, b_ext)
