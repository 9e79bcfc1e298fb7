"""Batched negacyclic monomial rotation: p(X) -> X^amt * p(X) mod X^N+1.

Counterpart of ``peba1_tpu/ops/rotate.py``.  The JAX package builds the
per-row rotation as a barrel shifter of static rolls because a gather is
slow on a TPU; here it is one gather with a sign, which PyTorch runs well on
both the CPU and the card.
"""

from __future__ import annotations

import torch

from ..torus import as_u32


def negacyclic_rotate(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """X^amt * p, batched: x (..., N) int32, amt (...) int32, taken mod 2N.

    amt broadcasts against x's leading dims (pass amt with explicit
    singleton dims to control broadcasting, e.g. (B, 1) against (B, K, N)).
    Coefficient t of the result is p[i] for i = (t - amt) mod 2N when i < N,
    and -p[i - N] otherwise.
    """
    N = x.shape[-1]
    t = torch.arange(N, device=x.device)
    i = (t - amt.to(torch.int64)[..., None]) & (2 * N - 1)
    lead = torch.broadcast_shapes(x.shape[:-1], i.shape[:-1])
    src = x.expand(lead + (N,))
    idx = (i & (N - 1)).expand(lead + (N,))
    y = torch.gather(src, -1, idx)
    return torch.where((i < N).expand(lead + (N,)), y, -y)


def initial_accumulator(amt0: torch.Tensor, mu: int, params) -> torch.Tensor:
    """The blind rotation's starting accumulator [0 | X^amt0 * (mu, ..., mu)].

    amt0: (B,) int32, the initial body rotation (2N - b_bar) mod 2N.
    Returns (B, (k+1)*N) int32: k zero mask polynomials, then the body.
    """
    p = params
    B = amt0.shape[0]
    acc = torch.zeros((B, p.k + 1, p.N), dtype=torch.int32, device=amt0.device)
    tv = torch.full((B, p.N), mu, dtype=torch.int32, device=amt0.device)
    acc[:, p.k] = negacyclic_rotate(tv, amt0)
    return acc.view(B, -1)


def modswitch_2n(a: torch.Tensor, N: int) -> torch.Tensor:
    """Torus32 -> Z_{2N}: round(a * 2N / 2^32), TFHE's modSwitchFromTorus32."""
    log2_2n = (2 * N).bit_length() - 1
    shift = 32 - log2_2n
    ua = as_u32(a) + (1 << (shift - 1))
    return ((ua >> shift) & (2 * N - 1)).to(torch.int32)
