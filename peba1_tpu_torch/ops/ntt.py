"""Exact integer negacyclic NTT (counterpart of ``peba1_tpu/ops/ntt.py``).

The prototype behind docs/NTT_DECISION.md: a bit-exact negacyclic NTT whose
operation counts ground the cost model that keeps the int8 Toeplitz GEMM as
the engine's external product.  It is off every bootstrap path, so it is
plain PyTorch on every device and has no kernel.

Arithmetic: prime field P = 754974721 = 45 * 2^24 + 1 (2^24 | P-1, so 2N-th
roots exist for every shipped ring size), primitive root G = 11.  Every
multiplication by a precomputed constant (stage twiddles, twist factors) is
Shoup's precomputed-quotient modmul:

    q = umulhi(w_shoup, x);  r = w*x - q*P (mod 2^32);  r -= P if r >= P

with umulhi from 16-bit halves, as the JAX package computes it.  The JAX
package holds residues as uint32; CPU torch has no uint32 shift, so here
they are int64 in [0, 2^32), and each product that wraps mod 2^32 there is
masked with ``& MASK32`` here.  No int64 product overflows: a 32x32 product
never forms (the halves keep every product below 2^48; w*x and q*P stay
below 2^62 since w, P < 2^30).

Exactness contract: `negacyclic_mul_exact(a, b)` returns the true signed
negacyclic convolution provided every output coefficient satisfies
|c| < P/2 ~ 2^28.2 (int8 digits x int8 key limbs at N <= 2048: < 2^25).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..torus import MASK32

P = 754974721            # 45 * 2^24 + 1
G = 11                   # primitive root of P
_M16 = 0xFFFF


@functools.lru_cache(maxsize=None)
def _tables(N: int):
    """Host-side precompute (numpy int64): bit-reversal permutation,
    per-stage twiddles (value, Shoup quotient), negacyclic twist factors and
    their inverses (the inverse twist folds in N^-1)."""
    if N & (N - 1) or (P - 1) % (2 * N):
        raise ValueError(f"N={N} is not a power of two with 2N | P-1")
    logn = N.bit_length() - 1
    rev = np.array([int(bin(i + N)[3:][::-1], 2) for i in range(N)], np.int64)
    w = pow(G, (P - 1) // N, P)        # primitive N-th root
    wi = pow(w, P - 2, P)
    psi = pow(G, (P - 1) // (2 * N), P)  # primitive 2N-th root (twist)
    psii = pow(psi, P - 2, P)
    ninv = pow(N, P - 2, P)

    def shoup(vals):
        vals = [int(v) for v in vals]
        return (np.array(vals, np.int64), np.array([(v << 32) // P for v in vals], np.int64))

    stages, stages_i = [], []
    for s in range(1, logn + 1):
        m, half = 1 << s, 1 << (s - 1)
        wm = pow(w, N // m, P)
        wmi = pow(wi, N // m, P)
        stages.append(shoup([pow(wm, j, P) for j in range(half)]))
        stages_i.append(shoup([pow(wmi, j, P) for j in range(half)]))
    twist = shoup([pow(psi, j, P) for j in range(N)])
    twist_i = shoup([(pow(psii, j, P) * ninv) % P for j in range(N)])
    return rev, stages, stages_i, twist, twist_i


def _umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of a*b for operands in [0, 2^32), via 16-bit halves (the
    JAX package's form: ~4 lowmuls + ~10 adds/shifts; no sum below wraps)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    t = a0 * b0
    mid = a1 * b0 + (t >> 16)
    mid2 = a0 * b1 + (mid & _M16)
    return a1 * b1 + (mid >> 16) + (mid2 >> 16)


def _mulmod_shoup(x: torch.Tensor, w, w_sh) -> torch.Tensor:
    """x * w mod P with precomputed w_sh = floor(w * 2^32 / P).  x < P."""
    q = _umulhi(torch.as_tensor(w_sh, device=x.device), x)
    r = (x * torch.as_tensor(w, device=x.device) - q * P) & MASK32   # in [0, 2P)
    return torch.where(r >= P, r - P, r)


def _addmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return torch.where(s >= P, s - P, s)


def _submod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(a >= b, a - b, a + P - b)


def _cyclic_ntt(x: torch.Tensor, stages, rev) -> torch.Tensor:
    """Iterative Cooley-Tukey over the last axis; x int64 residues."""
    N = x.shape[-1]
    x = x[..., torch.as_tensor(rev, device=x.device)]
    for wv, ws in stages:
        half = wv.shape[0]
        xr = x.reshape(x.shape[:-1] + (N // (2 * half), 2 * half))
        u = xr[..., :half]
        v = _mulmod_shoup(xr[..., half:], wv, ws)
        x = torch.cat([_addmod(u, v), _submod(u, v)], dim=-1).reshape(x.shape)
    return x


def _to_residue(x: torch.Tensor) -> torch.Tensor:
    """Signed int32 -> residue mod P in int64 (|x| < P/2 assumed)."""
    x = x.to(torch.int64)
    return torch.where(x < 0, x + P, x)


def _from_residue(r: torch.Tensor) -> torch.Tensor:
    """Residue -> signed int32 centered representative."""
    return torch.where(r > P // 2, r - P, r).to(torch.int32)


def ntt_negacyclic(x: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT of signed int32 coefficients (last axis) ->
    int64 residues in [0, P), the values of the JAX package's uint32 output."""
    rev, stages, _, twist, _ = _tables(x.shape[-1])
    r = _mulmod_shoup(_to_residue(x), *twist)
    return _cyclic_ntt(r, stages, rev)


def intt_negacyclic(X: torch.Tensor) -> torch.Tensor:
    """Inverse of ntt_negacyclic: residues -> signed int32 coefficients."""
    rev, _, stages_i, _, twist_i = _tables(X.shape[-1])
    r = _cyclic_ntt(X.to(torch.int64), stages_i, rev)
    return _from_residue(_mulmod_shoup(r, *twist_i))


def negacyclic_mul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact signed negacyclic convolution via NTT, valid while every output
    coefficient is < P/2 in magnitude.  The pointwise stage multiplies two
    data transforms, so it uses the generic modmul (neither side
    precomputed)."""
    return intt_negacyclic(_mulmod_generic(ntt_negacyclic(a), ntt_negacyclic(b)))


_SH16 = (1 << 16, ((1 << 16) << 32) // P)


def _mulmod_generic(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod P for two residue tensors (no precomputed quotient): b split
    in 16-bit halves, each partial product reduced from its (hi, lo) words,
    the high half then multiplied by 2^16 with Shoup."""
    b0, b1 = b & _M16, b >> 16
    r1 = _reduce64(_umulhi(a, b1), (a * b1) & MASK32)
    r1 = _mulmod_shoup(r1, *_SH16)
    r0 = _reduce64(_umulhi(a, b0), (a * b0) & MASK32)
    return _addmod(r1, r0)


def _reduce64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi*2^32 + lo) mod P: hi mod P times (2^32 mod P) by Shoup, plus lo
    mod P."""
    c = (1 << 32) % P
    t = _mulmod_shoup(hi % P, c, (c << 32) // P)
    return _addmod(t, lo % P)
