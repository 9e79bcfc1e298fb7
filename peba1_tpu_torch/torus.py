"""Torus32 arithmetic helpers (counterpart of ``peba1_tpu/torus.py``).

The real torus T = R/Z is represented by int32 with the natural scaling
t = round(x * 2^32); addition and negation wrap mod 2^32.

PyTorch has no uint32 shift on the CPU, so every unsigned step here runs in
int64 with an explicit ``& 0xFFFFFFFF`` and is wrapped back to int32 with
`wrap_i32`.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_TWO32 = 2.0**32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor mod 2^32 into int32's two's-complement range."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of an int32 tensor, held in int64."""
    return x.to(torch.int64) & MASK32


def double_to_torus32(x, dtype: torch.dtype = torch.float32,
                      device=None) -> torch.Tensor:
    """Map a real number (mod 1) to torus32.

    Computed in `dtype`: float32 is the JAX package's precision without
    ``jax_enable_x64`` (its default), float64 the precision with it.
    """
    frac = torch.as_tensor(x, dtype=dtype, device=device)
    frac = frac - torch.floor(frac)
    u = torch.remainder(torch.round(frac * _TWO32), _TWO32)
    return wrap_i32(u.to(torch.int64))


def modswitch_to_torus32(mu: int, msize: int) -> int:
    """Exact integer version of TFHE's modSwitchToTorus32 (python ints).

    Returns the torus32 encoding of mu/msize, e.g. (1, 8) -> 2^29.
    """
    interval = ((1 << 63) // msize) * 2  # 2^64 / msize
    phase64 = (mu * interval) % (1 << 64)
    t = ((phase64 + (1 << 31)) >> 32) & MASK32
    return int(np.int64(t).astype(np.int32))


def torus32_to_double(t, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Map torus32 back to a real in [-1/2, 1/2), in `dtype` (float32 as the
    JAX package without ``jax_enable_x64``)."""
    return torch.as_tensor(t, dtype=torch.int32).to(dtype) / _TWO32


def gaussian_torus32(gen: torch.Generator, stdev: float, shape,
                     device) -> torch.Tensor:
    """Torus32 gaussian noise with the given stdev (fraction of the torus).

    Draws in float64 and rounds to the nearest integer; stdev * 2^32 is at
    most 2^17 for every preset, so the values never come near the wrap.
    """
    shape = tuple(shape)
    if stdev == 0.0:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    g = torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    return wrap_i32(torch.round(g * (stdev * _TWO32)).to(torch.int64))


def uniform_torus32(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform torus32 elements (for LWE/TRLWE masks)."""
    u = torch.randint(0, 1 << 32, tuple(shape), generator=gen,
                      dtype=torch.int64, device=device)
    return wrap_i32(u)


def approx_phase(phase: torch.Tensor, msize: int) -> torch.Tensor:
    """Round a torus32 phase to the nearest multiple of 1/msize (approxPhase)."""
    interval = (1 << 32) // msize
    u = (as_u32(phase) + interval // 2) & MASK32
    return wrap_i32(u - u % interval)
