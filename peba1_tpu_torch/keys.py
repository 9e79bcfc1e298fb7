"""Key generation (counterpart of ``peba1_tpu/keys.py``).

The cloud key carries the forms that the port's bootstrap reads: ``bk_tp``,
the doubled limb-split Toeplitz generator of the bootstrapping key;
``bk_w``, every step's full Toeplitz weights, only where `need_w` holds;
and ``ks_table_limbs``, the keyswitch key as an int8 digit-matmul table.
Keygen also keeps the raw TRGSW key ``bk`` so that a saved key carries every
field the JAX package's loader reads.  The A-matrix form ``bk_amat`` and the
conv form ``bk_conv`` are not ported.

Randomness comes from an explicit ``torch.Generator``; it cannot reproduce
the JAX package's threefry draws, so keys cross between the two packages
only as tensors (`cloud_key_from_numpy`, `secret_key_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tlwe, torus
from .ops import poly
from .params import TfheParams


@dataclasses.dataclass
class SecretKey:
    lwe_key: torch.Tensor    # (n,) int32 bits -- the "small" key
    tlwe_key: torch.Tensor   # (k, N) int32 bits -- the ring key
    params: TfheParams

    @property
    def extracted_key(self) -> torch.Tensor:
        """(k*N,) int32 -- LWE key of sample-extracted ciphertexts."""
        return self.tlwe_key.reshape(-1)

    @property
    def device(self) -> torch.device:
        return self.lwe_key.device


@dataclasses.dataclass
class CloudKey:
    bk_tp: torch.Tensor            # (n, (k+1)l, C, 2N) int8 Toeplitz generator
    ks_table_limbs: torch.Tensor   # (kN*t, (n+1)*4) int8 digit-matmul table
    params: TfheParams
    bk: torch.Tensor | None = None  # (n, (k+1)l, k+1, N) int32 TRGSW(s_i)
    # (n, C*N, G*N) int8, G = (k+1)l: every step's full Toeplitz weights,
    # TRANSPOSED against the JAX package's (n, G*N, C*N) bk_w:
    # bk_w[s, c*N + j, g*N + t] = bk_tp[s, g, c, N - t + j].  Row-major along
    # the contraction, so the CUDA GEMM's B tiles load like its A tiles
    # (csrc/cmux_step.cu).  None unless need_w(params): 10.9 GB at
    # peba1_128_t2.
    bk_w: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.bk_tp.device


def need_w(p: TfheParams) -> bool:
    """Whether the cloud key must carry the fully materialized bk_w (the JAX
    package's rule, for keygen and loading alike): the streaming and
    generator kernels build W themselves."""
    return ((p.use_pallas_extprod or p.use_fused_step)
            and not p.w_streaming and not p.use_gen_step and not p.use_gen_full)


def active_bk_field(p: TfheParams) -> str:
    """Which CloudKey bootstrapping-key form ops.bootstrap.blind_rotate reads
    under `p`.  It follows the JAX package's branch order, except that the
    port reads ``bk_tp`` where the JAX package would read the unported
    ``bk_amat`` or ``bk_conv`` (the same product, through the Toeplitz
    generator)."""
    return "bk_w" if need_w(p) else "bk_tp"


def secret_keygen(gen: torch.Generator, params: TfheParams, device) -> SecretKey:
    """Uniform binary LWE and TRLWE keys."""
    lwe_key = torch.randint(0, 2, (params.n,), generator=gen,
                            dtype=torch.int32, device=device)
    tlwe_key = torch.randint(0, 2, (params.k, params.N), generator=gen,
                             dtype=torch.int32, device=device)
    return SecretKey(lwe_key=lwe_key, tlwe_key=tlwe_key, params=params)


def keygen(gen: torch.Generator, params: TfheParams,
           device) -> "tuple[SecretKey, CloudKey]":
    """A full secret/cloud keyset from one generator, on `device`."""
    sk = secret_keygen(gen, params, device)
    return sk, make_cloud_key(gen, sk)


def make_cloud_key(gen: torch.Generator, sk: SecretKey) -> CloudKey:
    p = sk.params
    # Bootstrapping key: TRGSW encryptions of each small-key bit, and its
    # Toeplitz-generator form.
    bk = tlwe.trgsw_encrypt(gen, sk.tlwe_key, sk.lwe_key, p)
    bk_tp = poly.prepare_toeplitz_rhs(bk, p.limb_plan)

    # Keyswitch key: ks[i][j] = LWE_s(K_i << shift_j); the switched sample
    # accumulates digit-value * row (ops/bootstrap.keyswitch_digits).
    kn = p.k * p.N
    shifts = torch.tensor([32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)],
                          dtype=torch.int64, device=sk.device)
    mu = torus.wrap_i32(sk.extracted_key.to(torch.int64)[:, None] << shifts)
    a = torus.uniform_torus32(gen, (kn, p.ks_t, p.n), sk.device)
    e = torus.gaussian_torus32(gen, p.lwe_stdev, (kn, p.ks_t), sk.device)
    b = poly.dot_key_i32(a, sk.lwe_key) + mu + e
    table = torch.cat([a, b[..., None]], dim=-1)      # (kN, t, n+1)
    ks_table_limbs = poly.split_limbs_i8(table, 4).reshape(kn * p.ks_t, (p.n + 1) * 4)
    bk_w = poly.prepare_w_full(bk_tp) if need_w(p) else None
    return CloudKey(bk_tp=bk_tp, ks_table_limbs=ks_table_limbs, params=p, bk=bk,
                    bk_w=bk_w)


def cloud_key_from_numpy(params: TfheParams, bk_tp, ks_table_limbs, device,
                         bk=None, bk_w=None) -> CloudKey:
    """A cloud key from the JAX package's arrays (numpy, or anything numpy
    converts): ``bk_tp`` (n, G, C, 2N) int8 and ``ks_table_limbs``
    (kN*t, (n+1)*4) int8, optionally the raw ``bk`` and JAX's ``bk_w``
    (n, G*N, C*N) int8, which is transposed step by step into the port's
    layout.  Where `need_w` holds and no ``bk_w`` is given, it is built from
    ``bk_tp``; where it does not hold, a given ``bk_w`` is dropped, as the
    JAX package's keygen would not have built it."""
    p = params
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    bk_tp = torch.as_tensor(np.asarray(bk_tp, np.int8), device=device)
    ks = torch.as_tensor(np.asarray(ks_table_limbs, np.int8), device=device)
    if tuple(bk_tp.shape) != (p.n, G, C, 2 * p.N):
        raise ValueError(f"bk_tp shape {tuple(bk_tp.shape)} does not fit {p}")
    if tuple(ks.shape) != (p.k * p.N * p.ks_t, (p.n + 1) * 4):
        raise ValueError(f"ks_table_limbs shape {tuple(ks.shape)} does not fit {p}")
    if bk is not None:
        bk = torch.as_tensor(np.asarray(bk, np.int32), device=device)
    if not need_w(p):
        bk_w = None
    elif bk_w is None:
        bk_w = poly.prepare_w_full(bk_tp)
    else:
        if tuple(bk_w.shape) != (p.n, G * p.N, C * p.N):
            raise ValueError(f"bk_w shape {tuple(bk_w.shape)} does not fit {p}")
        jax_w = bk_w
        bk_w = torch.empty((p.n, C * p.N, G * p.N), dtype=torch.int8, device=device)
        for s in range(p.n):
            bk_w[s] = torch.as_tensor(np.array(jax_w[s], np.int8), device=device).T
    return CloudKey(bk_tp=bk_tp, ks_table_limbs=ks, params=p, bk=bk, bk_w=bk_w)


def secret_key_from_numpy(params: TfheParams, lwe_key, tlwe_key,
                          device) -> SecretKey:
    """A secret key from the JAX package's ``lwe_key`` (n,) and ``tlwe_key``
    (k, N) bit arrays."""
    lwe_key = torch.as_tensor(np.asarray(lwe_key, np.int32), device=device)
    tlwe_key = torch.as_tensor(np.asarray(tlwe_key, np.int32), device=device)
    if tuple(lwe_key.shape) != (params.n,) or tuple(tlwe_key.shape) != (params.k, params.N):
        raise ValueError("secret key shapes do not fit the parameters")
    return SecretKey(lwe_key=lwe_key, tlwe_key=tlwe_key, params=params)
