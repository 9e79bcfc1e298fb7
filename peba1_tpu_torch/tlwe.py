"""TRLWE and TRGSW ciphertexts, batched (counterpart of ``peba1_tpu/tlwe.py``).

  TRLWE sample: (..., k+1, N) int32 -- k mask polynomials + body polynomial.
  TRGSW sample: (..., (k+1)*l, k+1, N) int32 -- a gadget matrix of TRLWE rows.
"""

from __future__ import annotations

import torch

from . import torus
from .ops import poly
from .params import TfheParams


def trivial(mu_poly: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Noiseless trivial TRLWE of message polynomial(s) (..., N) -> (..., k+1, N)."""
    mu_poly = torch.as_tensor(mu_poly, dtype=torch.int32)
    zeros = torch.zeros(mu_poly.shape[:-1] + (params.k, params.N), dtype=torch.int32,
                        device=mu_poly.device)
    return torch.cat([zeros, mu_poly[..., None, :]], dim=-2)


def encrypt_zero(gen: torch.Generator, tlwe_key: torch.Tensor,
                 params: TfheParams, shape=()) -> torch.Tensor:
    """TRLWE encryptions of 0: shape -> (*shape, k+1, N), on tlwe_key's device."""
    shape = tuple(shape)
    dev = tlwe_key.device
    a = torus.uniform_torus32(gen, shape + (params.k, params.N), dev)
    e = torus.gaussian_torus32(gen, params.tlwe_stdev, shape + (params.N,), dev)
    body = poly.key_negacyclic_mul(tlwe_key, a) + e
    return torch.cat([a, body[..., None, :]], dim=-2)


def encrypt(gen: torch.Generator, tlwe_key: torch.Tensor, mu_poly: torch.Tensor,
            params: TfheParams) -> torch.Tensor:
    """TRLWE encryption of message polynomial(s) (..., N) -> (..., k+1, N)."""
    z = encrypt_zero(gen, tlwe_key, params, shape=mu_poly.shape[:-1])
    z[..., -1, :] += mu_poly.to(torch.int32)
    return z


def phase(ct: torch.Tensor, tlwe_key: torch.Tensor) -> torch.Tensor:
    """(..., k+1, N) -> (..., N): body - sum_u s_u * a_u."""
    a, body = ct[..., :-1, :], ct[..., -1, :]
    return body - poly.key_negacyclic_mul(tlwe_key, a)


def sample_extract(ct: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Extract the constant coefficient as an LWE sample under the extracted key.

    ct: (..., k+1, N) -> (a: (..., k*N) int32, b: (...,) int32), with
    a'[u*N + 0] = a_u[0] and a'[u*N + j] = -a_u[N-j].
    """
    a, body = ct[..., :-1, :], ct[..., -1, :]
    flipped = torch.cat([a[..., :1], -a[..., 1:].flip(-1)], dim=-1)
    return flipped.reshape(a.shape[:-2] + (-1,)), body[..., 0]


def trgsw_encrypt(gen: torch.Generator, tlwe_key: torch.Tensor,
                  msg: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """TRGSW encryption of small integer message(s) (typically key bits).

    msg: (...,) int32 -> (..., (k+1)*l, k+1, N) int32.  Row (u*l + p) is a
    TRLWE zero-encryption plus msg * 2^(32-(p+1)*bgbit) added to component
    u's constant coefficient (the gadget matrix H).
    """
    rows = (params.k + 1) * params.l
    z = encrypt_zero(gen, tlwe_key, params, shape=tuple(msg.shape) + (rows,))
    for u in range(params.k + 1):
        for p in range(params.l):
            h = torus.wrap_i32(msg.to(torch.int64) << (32 - (p + 1) * params.bgbit))
            z[..., u * params.l + p, u, 0] += h
    return z


def external_product_reference(digits_fn, trlwe: torch.Tensor, trgsw: torch.Tensor,
                               params: TfheParams) -> torch.Tensor:
    """Oracle external product: decomp(trlwe) . trgsw.

    trlwe: (..., k+1, N); trgsw: ((k+1)*l, k+1, N); digits_fn: a decompose
    function (ops.decompose.decompose with the parameters bound).
    """
    G = (params.k + 1) * params.l
    d = digits_fn(trlwe).movedim(-1, -2)             # (..., k+1, l, N)
    batch = d.shape[:-3]
    flat = poly.negacyclic_extproduct_reference(
        d.reshape((-1, G, params.N)), trgsw.reshape(G, params.k + 1, params.N))
    return flat.reshape(batch + (params.k + 1, params.N))
