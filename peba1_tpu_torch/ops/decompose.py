"""Gadget (base-Bg) decomposition of torus32 polynomials.

Counterpart of ``peba1_tpu/ops/decompose.py``: signed balanced digits in
[-Bg/2, Bg/2) with a round-to-nearest offset, so that
sum_p d_p * 2^(32 - p*bgbit) reconstructs the input to l*bgbit bits and
decompose(0) == 0.  The uint32 arithmetic runs in int64 (no uint32 shift on
the CPU).
"""

from __future__ import annotations

import torch

from ..params import TfheParams
from ..torus import MASK32, as_u32, wrap_i32
from ..utils.device import from_host


def gadget_offset(params: TfheParams) -> int:
    """Digit-balancing plus round-to-nearest offset, as unsigned 32-bit.

    sum_{p=1..l} 2^(32 - p*bgbit) * Bg/2   (balanced digits in [-Bg/2, Bg/2))
    + 2^(32 - l*bgbit - 1)                 (half-ulp: round-to-nearest)
    """
    off = 1 << (32 - params.l * params.bgbit - 1)
    for p in range(1, params.l + 1):
        off += (1 << (32 - p * params.bgbit)) * params.half_bg
    return off % (1 << 32)


def decompose(x: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Decompose torus32 (...,) -> digits (..., l) int8 in [-Bg/2, Bg/2)."""
    u = (as_u32(x) + gadget_offset(params)) & MASK32
    shifts = from_host([32 - p * params.bgbit for p in range(1, params.l + 1)],
                       torch.int64, x.device)
    d = (u[..., None] >> shifts) & (params.bg - 1)
    return (d - params.half_bg).to(torch.int8)


def recompose(digits: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """sum_p digits[..., p] * 2^(32-(p+1)*bgbit) as int32 (approximate inverse)."""
    shifts = torch.tensor([32 - (p + 1) * params.bgbit for p in range(params.l)],
                          dtype=torch.int64, device=digits.device)
    return wrap_i32((digits.to(torch.int64) << shifts).sum(dim=-1))
