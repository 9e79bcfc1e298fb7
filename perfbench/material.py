"""The benchmark's inputs, made from the seed on the device: raw keys and
encryptions of bits.

Both sides get the same material: the program through its key-loading entry
(`perfbench.port`), the reference as it is (`perfbench.reference.tfhe.Keys`).
Each tensor is drawn in one call from a `torch.Generator` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.tfhe import MU_1_8, Keys, Lattice, dot_key, key_product

_TWO32 = float(1 << 32)


def seeds(seed: int, count: int) -> "list[int]":
    """`count` independent 63-bit seeds from the run's --seed (any integer)."""
    entropy = seed % (1 << 128)
    return [int(s) for s in np.random.SeedSequence(entropy).generate_state(count, np.uint64)
            >> np.uint64(1)]


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform torus32 elements as int32."""
    u = torch.randint(0, 1 << 32, tuple(shape), generator=gen, dtype=torch.int64,
                      device=gen.device)
    return (u - (1 << 31)).to(torch.int32)


def gaussian(gen: torch.Generator, stdev: float, shape) -> torch.Tensor:
    """Rounded Gaussian noise of `stdev` (a fraction of the torus), int64."""
    g = torch.randn(tuple(shape), generator=gen, dtype=torch.float64, device=gen.device)
    return torch.round(g * (stdev * _TWO32)).to(torch.int64)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def make_keys(lat: Lattice, gen: torch.Generator) -> Keys:
    """Binary keys, the TRGSW bootstrapping key and the keyswitching key."""
    lwe_key = torch.randint(0, 2, (lat.n,), generator=gen, dtype=torch.int32,
                            device=gen.device)
    tlwe_key = torch.randint(0, 2, (lat.k, lat.N), generator=gen, dtype=torch.int32,
                             device=gen.device)
    # Bootstrapping key: row u*l + p of step i is a TRLWE encryption of 0
    # plus s_i * 2^(32-(p+1)*bgbit) on component u's constant coefficient.
    mask = uniform(gen, (lat.n, lat.G, lat.k, lat.N))
    body = key_product(tlwe_key, mask) + gaussian(gen, lat.tlwe_stdev, (lat.n, lat.G, lat.N))
    bk = torch.cat([mask.to(torch.int64), body[:, :, None]], dim=2)
    rows = torch.arange(lat.G, device=gen.device)
    u, p = rows // lat.l, rows % lat.l
    gadget = lwe_key.to(torch.int64)[:, None] << (32 - (p + 1) * lat.bgbit)[None]
    bk[:, rows, u, 0] += gadget
    # Keyswitching key: entry (i, j) encrypts ring-key bit i times
    # 2^(32-(j+1)*basebit) under the small key.
    kn = lat.k * lat.N
    shifts = torch.tensor([32 - (j + 1) * lat.ks_basebit for j in range(lat.ks_t)],
                          device=gen.device)
    ks_mask = uniform(gen, (kn, lat.ks_t, lat.n))
    ks_body = (dot_key(ks_mask, lwe_key) + (tlwe_key.reshape(-1, 1).to(torch.int64) << shifts)
               + gaussian(gen, lat.lwe_stdev, (kn, lat.ks_t)))
    ks = torch.cat([ks_mask.to(torch.int64), ks_body[..., None]], dim=-1)
    return Keys(lwe_key=lwe_key, tlwe_key=tlwe_key, bk=_to_i32(bk), ks=_to_i32(ks))


def encrypt_bits(lat: Lattice, keys: Keys, gen: torch.Generator,
                 bits: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Fresh LWE encryptions of +-1/8 for bits (...,): (a (..., n), b (...,)) int32."""
    a = uniform(gen, tuple(bits.shape) + (lat.n,))
    mu = torch.where(bits.to(gen.device) != 0, MU_1_8, -MU_1_8).to(torch.int64)
    b = dot_key(a, keys.lwe_key) + mu + gaussian(gen, lat.lwe_stdev, bits.shape)
    return a, _to_i32(b)
