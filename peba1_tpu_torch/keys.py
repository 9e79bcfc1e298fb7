"""Key generation (counterpart of ``peba1_tpu/keys.py``).

The cloud key carries the JAX package's forms of the bootstrapping key: the
raw TRGSW key ``bk``; ``bk_conv``, its conv form; ``bk_tp``, the doubled
limb-split Toeplitz generator; ``bk_amat``, the A-matrix, only where
`need_amat` holds; ``bk_w``, every step's full Toeplitz weights, only where
`need_w` holds; and ``ks_table_limbs``, the keyswitch key as an int8
digit-matmul table.  ``bk_amat`` and ``bk_w`` are kept in the port's own
layouts (see `CloudKey`).

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
    # bk_w[s, c*N + j, g*N + t] = bk_tp[s, g, c, N - t + j].  The
    # contraction runs along a row (K-major, as wgmma takes an int8 B
    # operand), so a TMA box of 64 rows x 128 bytes is one limb of a weight
    # tile (csrc/cmux_step.cu).  None unless need_w(params): 10.9 GB at
    # peba1_128_t2.
    bk_w: torch.Tensor | None = None
    # (n, C, G, span, K) int8: the A-matrix (ops/poly.prepare_amat), the last
    # two axes transposed against the JAX package's (n, C, G, K, span), so
    # that the K contraction bytes of one output column are contiguous
    # (csrc/fused_blind_rotate.cu).  None unless need_amat(params): 4.34 GB
    # at peba1_128_fast with K=128.
    bk_amat: torch.Tensor | None = None
    bk_conv: torch.Tensor | None = None  # (n, C, (k+1)l, N) int8 conv form

    @property
    def device(self) -> torch.device:
        return self.ks_table_limbs.device


def need_amat(p: TfheParams) -> bool:
    """Whether the cloud key must carry the A-matrix form bk_amat."""
    return p.ext_backend == "amat" or p.use_fused_cmux


def need_w(p: TfheParams) -> bool:
    """Whether the cloud key must carry the fully materialized bk_w (the JAX
    package's rule, for keygen and loading alike): the streaming and
    generator kernels build W themselves."""
    return ((p.use_pallas_extprod or p.use_fused_step)
            and not p.w_streaming and not p.use_gen_step and not p.use_gen_full)


def active_bk_field(p: TfheParams) -> str:
    """Which CloudKey bootstrapping-key form ops.bootstrap.blind_rotate reads
    under `p` (the JAX package's branch order exactly)."""
    if p.use_fused_cmux:
        return "bk_amat"
    if p.use_gen_full or p.use_gen_step:
        return "bk_tp"
    if p.use_fused_step:
        return "bk_tp" if p.w_streaming else "bk_w"
    if p.use_pallas_extprod:
        return "bk_w"
    return {"toeplitz": "bk_tp", "conv": "bk_conv", "amat": "bk_amat"}[p.ext_backend]


_BK_FIELDS = ("bk", "bk_conv", "bk_tp", "bk_amat", "bk_w")


def slim_for_bootstrap(ck: CloudKey) -> CloudKey:
    """The cloud key with every bootstrapping-key form but the one the
    bootstrap reads dropped (the keyswitch table stays)."""
    active = active_bk_field(ck.params)
    return dataclasses.replace(ck, **{f: None for f in _BK_FIELDS if f != active})


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
    # conv and Toeplitz-generator forms.
    bk = tlwe.trgsw_encrypt(gen, sk.tlwe_key, sk.lwe_key, p)
    bk_conv = poly.prepare_conv_rhs(bk, p.limb_plan)
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
    bk_amat = poly.prepare_amat(bk_tp, p.amat_block) if need_amat(p) else None
    return CloudKey(bk_tp=bk_tp, ks_table_limbs=ks_table_limbs, params=p, bk=bk,
                    bk_w=bk_w, bk_amat=bk_amat, bk_conv=bk_conv)


def _transposed_steps(jax_form, shape: tuple, name: str, device) -> torch.Tensor:
    """JAX's per-step key form `name`, of shape (n, ..., a, b), as
    (n, ..., b, a) on `device`, one step at a time (the host copy never
    holds more than a step)."""
    if tuple(jax_form.shape) != shape:
        raise ValueError(f"{name} shape {tuple(jax_form.shape)} is not {shape}")
    out = torch.empty(shape[:-2] + (shape[-1], shape[-2]), dtype=torch.int8, device=device)
    for s in range(shape[0]):
        out[s] = torch.as_tensor(np.array(jax_form[s], np.int8),
                                 device=device).transpose(-1, -2)
    return out


def cloud_key_from_numpy(params: TfheParams, bk_tp, ks_table_limbs, device,
                         bk=None, bk_w=None, bk_amat=None, bk_conv=None) -> CloudKey:
    """A cloud key from the JAX package's arrays (numpy, or anything numpy
    converts): ``bk_tp`` (n, G, C, 2N) int8 and ``ks_table_limbs``
    (kN*t, (n+1)*4) int8; optionally the raw ``bk``, ``bk_conv``
    (n, C, G, N), and JAX's ``bk_w`` (n, G*N, C*N) and ``bk_amat``
    (n, C, G, K, span) int8, which are transposed step by step into the
    port's layouts.  Where `need_w` (`need_amat`) holds and no ``bk_w``
    (``bk_amat``) is given, it is built from ``bk_tp``; where it does not
    hold, a given one is dropped, as the JAX package's keygen would not have
    built it."""
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
    if bk_conv is not None:
        bk_conv = torch.as_tensor(np.asarray(bk_conv, np.int8), device=device)
        if tuple(bk_conv.shape) != (p.n, C, G, p.N):
            raise ValueError(f"bk_conv shape {tuple(bk_conv.shape)} does not fit {p}")
    if not need_w(p):
        bk_w = None
    elif bk_w is None:
        bk_w = poly.prepare_w_full(bk_tp)
    else:
        bk_w = _transposed_steps(bk_w, (p.n, G * p.N, C * p.N), "bk_w", device)
    if not need_amat(p):
        bk_amat = None
    elif bk_amat is None:
        bk_amat = poly.prepare_amat(bk_tp, p.amat_block)
    else:
        K, _, span = poly.amat_geometry(p.N, p.amat_block)
        bk_amat = _transposed_steps(bk_amat, (p.n, C, G, K, span), "bk_amat", device)
    return CloudKey(bk_tp=bk_tp, ks_table_limbs=ks, params=p, bk=bk, bk_w=bk_w,
                    bk_amat=bk_amat, bk_conv=bk_conv)


def secret_key_from_numpy(params: TfheParams, lwe_key, tlwe_key,
                          device) -> SecretKey:
    """A secret key from the JAX package's ``lwe_key`` (n,) and ``tlwe_key``
    (k, N) bit arrays."""
    lwe_key = torch.as_tensor(np.asarray(lwe_key, np.int32), device=device)
    tlwe_key = torch.as_tensor(np.asarray(tlwe_key, np.int32), device=device)
    if tuple(lwe_key.shape) != (params.n,) or tuple(tlwe_key.shape) != (params.k, params.N):
        raise ValueError("secret key shapes do not fit the parameters")
    return SecretKey(lwe_key=lwe_key, tlwe_key=tlwe_key, params=params)
