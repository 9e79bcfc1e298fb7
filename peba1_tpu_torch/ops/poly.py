"""Negacyclic polynomial arithmetic in Z[X]/(X^N + 1) over torus32.

Counterpart of the parts of ``peba1_tpu/ops/poly.py`` that the gate
bootstrap reads, with the key's Toeplitz, full-weight, A-matrix and conv
forms, and the ring-TP column slices (`negacyclic_toeplitz_cols`,
`extprod_toeplitz_cols_i8`).  Every function gives the JAX function's exact
result mod 2^32.

Integer products: ``torch.matmul`` of two int8 tensors returns int8 and
wraps, and CUDA has no integer matmul.  The plain products here therefore run
in float64, which is exact while every partial sum stays below 2^53:
  * `extprod_toeplitz_i8`, `extprod_toeplitz_cols_i8`, `extprod_amat_i8`,
    `negacyclic_conv_i8`: (k+1)*l*N * 128 * 128 < 2^31 (asserted by
    TfheParams);
  * `key_negacyclic_mul`: k*N * 2^31 <= 2^42 for every preset;
  * `dot_key_i32`: n * 2^31 < 2^42.
On the card the external product of every preset is a hand-written kernel
in ``ops/cuda_kernels.py``, except at the presets whose JAX path left it to
XLA (``peba1_128_fast``, ``peba1_128``, ``ring_2048``): there it is
`extprod_toeplitz_i8` in float64, as the JAX package's is a plain XLA dot.
So is `extprod_toeplitz_cols_i8` on every device (ring-TP's product, a
plain dot in the JAX package too).
"""

from __future__ import annotations

import torch

from ..torus import MASK32, wrap_i32
from ..utils.device import from_host


def exact_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Integer matmul through float64 -> int64; exact below 2^53 (see above)."""
    return torch.matmul(x.to(torch.float64), y.to(torch.float64)).to(torch.int64)


def negacyclic_matrix(q: torch.Tensor) -> torch.Tensor:
    """M with (p @ M) = p*q mod X^N+1: M[t, j] = q[(j - t) mod N] * (j<t ? -1 : 1)."""
    N = q.shape[-1]
    j = torch.arange(N, device=q.device)[None, :]
    t = torch.arange(N, device=q.device)[:, None]
    m = q[..., (j - t) % N]
    return torch.where(j >= t, m, -m)


def negacyclic_mul_naive(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product mod 2^32 (test oracle); p, q int32, broadcast
    leading dims.  Each product is reduced mod 2^32 before the sum, so the
    int64 sum of N terms cannot overflow."""
    m = negacyclic_matrix(q.to(torch.int32)).to(torch.int64)
    prod = (p.to(torch.int64)[..., :, None] * m) & MASK32
    return wrap_i32(prod.sum(dim=-2))


def round_to_limbs(x: torch.Tensor, limbs: int) -> torch.Tensor:
    """Round torus32 to the top `limbs` bytes (the canonical truncated value
    that split_limbs_i8(x, limbs) represents); identity when limbs == 4."""
    if limbs >= 4:
        return x.to(torch.int32)
    drop = 8 * (4 - limbs)
    return wrap_i32((x.to(torch.int64) + (1 << (drop - 1))) & (-1 << drop))


def split_limbs_i8(x: torch.Tensor, limbs: int = 4) -> torch.Tensor:
    """Split int32 into `limbs` balanced signed 8-bit limbs (axis appended last).

    x == sum_m out[..., m] * 2^(8m) (mod 2^32) when limbs == 4; when
    limbs < 4 the value is first rounded to the top `limbs` bytes.  Each limb
    is in [-128, 127].  The carry runs in int64; it differs from the JAX
    package's int32 carry only by multiples of 2^32 >> 8m, which never reach
    the low byte that the next limb reads.
    """
    x = round_to_limbs(x, limbs).to(torch.int64)
    r = x >> (8 * (4 - limbs))
    out = []
    for _ in range(limbs):
        limb = ((r + 128) & 255) - 128
        out.append(limb.to(torch.int8))
        r = (r - limb) >> 8
    return torch.stack(out, dim=-1)


def _limb_shifts(plan, device) -> torch.Tensor:
    """Shift of each (output, limb) column: 8*(4 - nl) + 8*m for limb m."""
    return from_host([8 * (4 - nl) + 8 * m for nl in plan for m in range(nl)],
                     torch.int64, device)


def recombine_limbs_i32(conv: torch.Tensor, limbs: int) -> torch.Tensor:
    """Inverse of split_limbs_i8 over the last axis; wraps mod 2^32.  Each
    shifted limb is below 2^31 * 2^24, so the int64 sum of 4 cannot overflow."""
    shifted = conv.to(torch.int64) << _limb_shifts((limbs,), conv.device)
    return wrap_i32(shifted.sum(dim=-1))


def as_limb_plan(limbs, n_out: int) -> "tuple[int, ...]":
    """Normalize an int or per-output tuple into a limb plan of length n_out."""
    if isinstance(limbs, int):
        return (limbs,) * n_out
    plan = tuple(limbs)
    if len(plan) != n_out:
        raise ValueError(f"limb plan {plan} does not have {n_out} outputs")
    return plan


def recombine_plan_i32(cols: torch.Tensor, plan: "tuple[int, ...]") -> torch.Tensor:
    """Recombine per-(output, limb) columns into O torus32 outputs.

    cols: (B, C, N) int32 with C = sum(plan), columns output-major (output
    o's plan[o] limbs contiguous, low limb first) -> (B, O, N).
    """
    B, _, N = cols.shape
    group = from_host([o for o, nl in enumerate(plan) for _ in range(nl)], torch.int64,
                      cols.device)
    shifted = cols.to(torch.int64) << _limb_shifts(plan, cols.device)[:, None]
    out = torch.zeros((B, len(plan), N), dtype=torch.int64, device=cols.device)
    return wrap_i32(out.index_add_(1, group, shifted))


def doubled_neg(q: torch.Tensor) -> torch.Tensor:
    """vv = cat(-q, q) along the last axis: the generator vector from which
    every negacyclic-Toeplitz row is a contiguous window (row t = vv[N-t:2N-t])."""
    return torch.cat([-q, q], dim=-1)


def negacyclic_toeplitz(vv: torch.Tensor) -> torch.Tensor:
    """The negacyclic matrix W[.., t, j] = vv[.., N - t + j] from the doubled
    generator vv (..., 2N) -> (..., N, N): row t is the window starting at
    N - t, vv's sliding windows in reverse (``flip`` makes it a copy)."""
    N = vv.shape[-1] // 2
    return vv.unfold(-1, N, 1)[..., 1:N + 1, :].flip(-2)


def prepare_w_full(vv: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Every step's full Toeplitz weights, in the port's transposed layout.

    vv: (n, G, C, 2N) int8 doubled limb generator (CloudKey.bk_tp) ->
    (n, C*N, G*N) int8 with W[s, c*N + j, g*N + t] = vv[s, g, c, N - t + j],
    the transpose of each step of ``peba1_tpu.ops.poly.prepare_w_full``
    (see ``keys.CloudKey.bk_w``).  Built `chunk` steps at a time so that the
    Toeplitz intermediate stays near 1 GB (10.9 GB of output at
    peba1_128_t2).
    """
    n, G, C, n2 = vv.shape
    N = n2 // 2
    if chunk is None:
        chunk = max(1, min(n, 2**30 // (G * C * N * N)))
    out = torch.empty((n, C * N, G * N), dtype=torch.int8, device=vv.device)
    for s in range(0, n, chunk):
        w = negacyclic_toeplitz(vv[s:s + chunk])         # (c, G, C, N_t, N_j)
        out[s:s + chunk].view(-1, C, N, G, N).copy_(w.permute(0, 2, 4, 1, 3))
    return out


def toeplitz_weights(vv_step: torch.Tensor) -> torch.Tensor:
    """One step of `prepare_w_full`: (G, C, 2N) -> (C*N, G*N) int8."""
    return prepare_w_full(vv_step[None])[0]


def extprod_toeplitz_i8(digits: torch.Tensor, vv_limbs: torch.Tensor,
                        limbs) -> torch.Tensor:
    """External product via the explicit negacyclic-Toeplitz matrix.

    digits: (B, G, N) int8; vv_limbs: (G, C, 2N) int8 (from
    `prepare_toeplitz_rhs`).  Returns (B, O, N) int32 mod 2^32.
    """
    B, G, N = digits.shape
    C = vv_limbs.shape[1]
    plan = limbs if isinstance(limbs, tuple) else as_limb_plan(limbs, C // limbs)
    # W[t, j] = vv[N - t + j] (`negacyclic_toeplitz`) reads vv backwards
    # along t; with the digits reversed along t it is the forward window
    # vv[1 + t' + j], a view of vv, so W itself needs no flip.
    W = vv_limbs.unfold(-1, N, 1)[..., 1:N + 1, :]  # (G, C, N_t', N_j)
    W = W.movedim(2, 1).reshape(G * N, C * N)
    out = exact_matmul(digits.flip(-1).reshape(B, G * N), W).to(torch.int32)
    return recombine_plan_i32(out.reshape(B, C, N), plan)


def negacyclic_toeplitz_cols(vv: torch.Tensor, j0: int, nj: int) -> torch.Tensor:
    """Columns [j0, j0+nj) of `negacyclic_toeplitz`: W[.., t, dj] =
    vv[.., N - t + j0 + dj], (..., 2N) -> (..., N, nj).

    The ring-dimension tensor-parallel building block: a tp rank assembles
    only its slice of each step's weights from the replicated generator.
    j0 is a Python int (rank * nj); row t is the window of vv starting at
    N - t + j0.  Requires 0 <= j0 <= N - nj.
    """
    N = vv.shape[-1] // 2
    if not 0 <= j0 <= N - nj:
        raise ValueError(f"columns [{j0}, {j0 + nj}) are not within N={N}")
    return vv.unfold(-1, nj, 1)[..., j0 + 1:j0 + N + 1, :].flip(-2)


def extprod_toeplitz_cols_i8(digits: torch.Tensor, vv_limbs: torch.Tensor, limbs,
                             j0: int, nj: int) -> torch.Tensor:
    """Columns [j0, j0+nj) of `extprod_toeplitz_i8`, bit for bit.

    digits: (B, G, N) int8; vv_limbs: (G, C, 2N) int8.  Returns (B, O, nj)
    int32: each output coefficient is an independent dot against the digit
    rows, so tp ranks that compute their slices and gather them reproduce
    the full product exactly.
    """
    B, G, N = digits.shape
    C = vv_limbs.shape[1]
    if not 0 <= j0 <= N - nj:
        raise ValueError(f"columns [{j0}, {j0 + nj}) are not within N={N}")
    plan = limbs if isinstance(limbs, tuple) else as_limb_plan(limbs, C // limbs)
    # With the digits reversed along t (as in `extprod_toeplitz_i8`), row t'
    # of the slice is the forward window vv[1 + j0 + t' :], a view of vv.
    W = vv_limbs.unfold(-1, nj, 1)[..., j0 + 1:j0 + N + 1, :]   # (G, C, N_t', nj)
    W = W.movedim(2, 1).reshape(G * N, C * nj)
    out = exact_matmul(digits.flip(-1).reshape(B, G * N), W).to(torch.int32)
    return recombine_plan_i32(out.reshape(B, C, nj), plan)


def prepare_toeplitz_rhs(q: torch.Tensor, limbs) -> torch.Tensor:
    """Doubled limb-split generator for `extprod_toeplitz_i8`.

    q: (..., G, O, N) int32 -> (..., G, C, 2N) int8; C = sum(limb plan),
    columns output-major, low limb first.

    Each output is rounded ONCE to its nl-byte value q_r, and the negated
    half is split from -q_r (int32) rather than by negating the limbs of q_r:
    balanced limbs reach -128, whose int8 negation overflows.
    """
    plan = as_limb_plan(limbs, q.shape[-2])
    cols = []
    for o, nl in enumerate(plan):
        q_r = round_to_limbs(q[..., o, :], nl)
        neg = split_limbs_i8(-q_r, nl)            # (..., G, N, nl)
        pos = split_limbs_i8(q_r, nl)
        vv = torch.cat([neg, pos], dim=-2)        # (..., G, 2N, nl)
        cols.append(vv.movedim(-1, -2))           # (..., G, nl, 2N)
    return torch.cat(cols, dim=-2)


def prepare_conv_rhs(q: torch.Tensor, limbs) -> torch.Tensor:
    """The conv form of the key (CloudKey.bk_conv), read by
    `negacyclic_conv_i8`.

    q: (..., G, O, N) int32 -> (..., C, G, N) int8, limb-split and reversed
    along N.
    """
    plan = as_limb_plan(limbs, q.shape[-2])
    chans = [split_limbs_i8(q[..., o, :], nl).movedim(-1, -3)
             for o, nl in enumerate(plan)]        # (..., nl, G, N) each
    return torch.cat(chans, dim=-3).flip(-1)


def negacyclic_conv_i8(digits: torch.Tensor, q_limbs_flipped: torch.Tensor,
                       limbs) -> torch.Tensor:
    """External product against the conv form of the key (`prepare_conv_rhs`).

    digits: (B, G, N) int8; q_limbs_flipped: (C, G, N) int8, one channel per
    (output, limb) column, reversed along N.  Returns (B, O, N) int32:
    sum_g digits[:, g] * q[g, o] mod X^N+1, mod 2^32, as the JAX package's
    int8 convolution gives it.  Here the product is one float64 GEMM against
    the negacyclic matrices of the unreversed channels: exact, since every
    sum stays below (k+1)*l*N*128*128 < 2^31 (no convolution routine, so no
    TF32 or FFT algorithm can enter).
    """
    B, G, N = digits.shape
    C = q_limbs_flipped.shape[0]
    plan = limbs if isinstance(limbs, tuple) else as_limb_plan(limbs, C // limbs)
    m = negacyclic_matrix(q_limbs_flipped.flip(-1).to(torch.int32))  # (C, G, N_t, N_j)
    w = m.permute(1, 2, 0, 3).reshape(G * N, C * N)
    out = exact_matmul(digits.reshape(B, G * N), w).to(torch.int32)
    return recombine_plan_i32(out.reshape(B, C, N), plan)


def amat_geometry(N: int, block: int) -> "tuple[int, int, int]":
    """(K, U, span) of the A-matrix at ring degree N and fine block `block`:
    K = min(block, N), U = N // K, span = N + (U-1)*K."""
    K = min(block, N)
    U = N // K
    return K, U, N + (U - 1) * K


def prepare_amat(vv: torch.Tensor, block: int = 128,
                 chunk: int | None = None) -> torch.Tensor:
    """The A-matrix form of the key (CloudKey.bk_amat), in the port's layout.

    vv: (n, G, C, 2N) int8 doubled limb generator (CloudKey.bk_tp) ->
    (n, C, G, span, K) int8 with
      A[s, c, g, i, kappa] = vv[s, g, c, (N - (U-1)K) - kappa + i],
    the transpose of the last two axes of
    ``peba1_tpu.ops.poly.prepare_amat``'s (n, C, G, K, span).  Step s's
    Toeplitz weight of contraction row t = u*K + kappa and output column
    (c, j) is A[s, c, g, j + (U-1-u)K, kappa], so the K contraction bytes of
    one column within one coarse block u are contiguous (the CUDA kernel's
    B-tile rows, csrc/fused_blind_rotate.cu).  Built `chunk` steps at a time
    so that the intermediate stays near 1 GB (4.34 GB of output at
    peba1_128_fast with K=128).
    """
    n, G, C, n2 = vv.shape
    N = n2 // 2
    K, U, span = amat_geometry(N, block)
    if chunk is None:
        chunk = max(1, min(n, 2**30 // (G * C * span * K)))
    out = torch.empty((n, C, G, span, K), dtype=torch.int8, device=vv.device)
    for s in range(0, n, chunk):
        # Window w of unfold holds vv[w : w+K]; A's row i reads it backwards
        # from (N - (U-1)K) + i = K + i, i.e. window 1 + i reversed.
        win = vv[s:s + chunk].unfold(-1, K, 1)[..., 1:span + 1, :].flip(-1)
        out[s:s + chunk].copy_(win.transpose(1, 2))
    return out


def extprod_amat_i8(digits: torch.Tensor, a_step: torch.Tensor, limbs,
                    N: int) -> torch.Tensor:
    """External product against one step of the A-matrix (`prepare_amat`).

    digits: (B, G, N) int8; a_step: (C, G, span, K) int8.  Returns (B, O, N)
    int32 mod 2^32, equal to ``peba1_tpu.ops.poly.extprod_amat_i8``: the
    weights assembled from U row slices, one float64 GEMM (exact, see above).
    """
    B, G, _ = digits.shape
    C, _, _, K = a_step.shape
    plan = limbs if isinstance(limbs, tuple) else as_limb_plan(limbs, C // limbs)
    U = N // K
    w = torch.stack([a_step[:, :, (U - 1 - u) * K:(U - 1 - u) * K + N]
                     for u in range(U)], dim=3)          # (C, G, N_j, U, K)
    w = w.permute(0, 2, 1, 3, 4).reshape(C * N, G * N)   # row (c, j), column (g, t)
    out = exact_matmul(digits.reshape(B, G * N), w.T).to(torch.int32)
    return recombine_plan_i32(out.reshape(B, C, N), plan)


def key_negacyclic_mul(key_bits: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """sum_u key_u * a_u mod X^N+1, exact.

    key_bits: (k, N) 0/1; a: (..., k, N) torus32.  Returns (..., N) int32.
    One float64 matmul against the key's negacyclic matrices (|sum| <= k*N*2^31).
    """
    k, N = key_bits.shape
    m = negacyclic_matrix(key_bits.to(torch.int32)).reshape(k * N, N)
    out = exact_matmul(a.reshape(a.shape[:-2] + (k * N,)), m)
    return wrap_i32(out)


def dot_key_i32(a: torch.Tensor, key_bits: torch.Tensor) -> torch.Tensor:
    """Exact <a, key> mod 2^32 for a binary key: (..., n) int32 x (n,) -> (...,)."""
    return wrap_i32(exact_matmul(a, key_bits))


def negacyclic_extproduct_reference(digits: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Oracle: (B, G, N) int32 digits x (G, O, N) int32 -> (B, O, N) int32,
    mod 2^32.  Each product is reduced before it is summed, so the int64 sums
    of G*N terms cannot overflow."""
    m = negacyclic_matrix(q.to(torch.int32)).to(torch.int64)     # (G, O, N, N)
    d = digits.to(torch.int64)
    out = torch.zeros((d.shape[0], m.shape[1], m.shape[3]), dtype=torch.int64,
                      device=d.device)
    for g in range(m.shape[0]):
        out += ((d[:, g, None, :, None] * m[g][None]) & MASK32).sum(dim=-2)
    return wrap_i32(out)
