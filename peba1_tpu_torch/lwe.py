"""LWE ciphertexts over torus32, batched (counterpart of ``peba1_tpu/lwe.py``).

Arbitrary leading batch dims over a trailing mask dimension.  All linear
homomorphic ops are elementwise int32 with wrap-around mod 2^32.
"""

from __future__ import annotations

import dataclasses

import torch

from . import torus
from .ops import poly


@dataclasses.dataclass
class Lwe:
    """Batched LWE ciphertext(s): phase(c) = b - <a, s>.

    a: (..., dim) int32 mask
    b: (...,)    int32 body
    """

    a: torch.Tensor
    b: torch.Tensor

    @property
    def dim(self) -> int:
        return self.a.shape[-1]

    @property
    def shape(self):
        return tuple(self.b.shape)

    def __add__(self, other: "Lwe") -> "Lwe":
        return Lwe(self.a + other.a, self.b + other.b)

    def __sub__(self, other: "Lwe") -> "Lwe":
        return Lwe(self.a - other.a, self.b - other.b)

    def __neg__(self) -> "Lwe":
        return Lwe(-self.a, -self.b)

    def scale(self, c: int) -> "Lwe":
        return Lwe(self.a * c, self.b * c)

    def add_const(self, mu: int) -> "Lwe":
        """Add a plaintext torus32 constant to the body."""
        return Lwe(self.a, self.b + mu)

    def __getitem__(self, idx) -> "Lwe":
        # Indices address the batch dims (b's shape); `a` carries one extra
        # trailing mask dim, so append a full slice for it.
        t = idx if isinstance(idx, tuple) else (idx,)
        return Lwe(self.a[t + (slice(None),)], self.b[idx])


def trivial(mu, dim: int, shape, device) -> Lwe:
    """Noiseless trivial ciphertext (a=0, b=mu) -- TFHE's bootsCONSTANT core.
    mu: a Python int (filled on the device) or a tensor broadcastable to
    `shape`."""
    shape = tuple(shape)
    if isinstance(mu, int):
        b = torch.full(shape, mu, dtype=torch.int32, device=device)
    else:
        b = torch.as_tensor(mu, dtype=torch.int32, device=device).expand(shape).clone()
    return Lwe(torch.zeros(shape + (dim,), dtype=torch.int32, device=device), b)


def encrypt(gen: torch.Generator, sk: torch.Tensor, mu: torch.Tensor,
            stdev: float) -> Lwe:
    """Encrypt torus32 message(s) under binary key sk (dim,), batched over mu."""
    dim = sk.shape[-1]
    a = torus.uniform_torus32(gen, mu.shape + (dim,), mu.device)
    e = torus.gaussian_torus32(gen, stdev, mu.shape, mu.device)
    return Lwe(a, poly.dot_key_i32(a, sk) + mu + e)


def phase(ct: Lwe, sk: torch.Tensor) -> torch.Tensor:
    """Decryption phase b - <a, s> (torus32)."""
    return ct.b - poly.dot_key_i32(ct.a, sk)


def decrypt_bit(ct: Lwe, sk: torch.Tensor) -> torch.Tensor:
    """Gate-bootstrapping bit decryption: sign of the phase (bootsSymDecrypt)."""
    return (phase(ct, sk) > 0).to(torch.int32)


def _a_axis(axis: int) -> int:
    """Batch-dim axis for the mask tensor (extra trailing mask dim)."""
    return axis if axis >= 0 else axis - 1


def stack(cts, axis: int = 0) -> Lwe:
    return Lwe(torch.stack([c.a for c in cts], dim=_a_axis(axis)),
               torch.stack([c.b for c in cts], dim=axis))


def concatenate(cts, axis: int = 0) -> Lwe:
    return Lwe(torch.cat([c.a for c in cts], dim=_a_axis(axis)),
               torch.cat([c.b for c in cts], dim=axis))


def where(pred: torch.Tensor, x: Lwe, y: Lwe) -> Lwe:
    """Row-wise select: x where pred holds, else y (pred has the batch shape)."""
    return Lwe(torch.where(pred[..., None], x.a, y.a), torch.where(pred, x.b, y.b))
