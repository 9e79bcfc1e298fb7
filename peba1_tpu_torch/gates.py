"""Bootstrapped Boolean gate API, batched (counterpart of ``peba1_tpu/gates.py``).

Every gate broadcasts over arbitrary leading batch dims; each two-input gate
costs one batched bootstrap + keyswitch, MUX costs two bootstraps + one
keyswitch, and NOT/COPY/CONSTANT are free.  `lincomb_bootstrap` is the
levelized entry point: a per-element linear combination wa*a + wb*b + offset
followed by one shared bootstrap.

The JAX package pads every flat batch to a power of two (``_bucket``) only to
bound XLA's compile cache.  Rows are independent and PyTorch compiles
nothing, so this package bootstraps the exact batch and pads nothing.
"""

from __future__ import annotations

import math

import torch

from . import lwe
from .keys import CloudKey
from .ops import bootstrap as bs
from .torus import modswitch_to_torus32
from .utils.device import from_host
from .utils.logging import span

MU_1_8 = modswitch_to_torus32(1, 8)   # +1/8 torus32 == 2^29
MU_1_4 = modswitch_to_torus32(1, 4)   # +1/4


def expand(ct: lwe.Lwe, shape) -> lwe.Lwe:
    """Broadcast a ciphertext to the batch shape `shape` (a view)."""
    shape = tuple(shape)
    return lwe.Lwe(ct.a.expand(shape + (ct.dim,)), ct.b.expand(shape))


def flatten(ct: lwe.Lwe) -> lwe.Lwe:
    return lwe.Lwe(ct.a.reshape(-1, ct.dim), ct.b.reshape(-1))


def unflatten(ct: lwe.Lwe, shape) -> lwe.Lwe:
    shape = tuple(shape)
    return lwe.Lwe(ct.a.reshape(shape + (ct.dim,)), ct.b.reshape(shape))


def gate_bootstrap(ck: CloudKey, pre: lwe.Lwe) -> lwe.Lwe:
    """Bootstrap an arbitrary-shaped batch of prepared gate inputs to +-1/8."""
    return unflatten(bs.bootstrap(ck, flatten(pre), MU_1_8), pre.shape)


def lincomb_bootstrap(ck: CloudKey, a: lwe.Lwe, b: lwe.Lwe, wa, wb, offset) -> lwe.Lwe:
    """Generic two-input gate: bootstrap(wa*a + wb*b + (0, offset)).

    wa, wb: ints or int tensors broadcastable to the gate batch shape;
    offset: torus32 likewise.
    """
    with span("prepare"):
        wa = from_host(wa, torch.int32, ck.device)
        wb = from_host(wb, torch.int32, ck.device)
        offset = from_host(offset, torch.int32, ck.device)
        shape = torch.broadcast_shapes(a.shape, b.shape, wa.shape, offset.shape)
        pre = lwe.Lwe(a.a * wa[..., None] + b.a * wb[..., None],
                      a.b * wa + b.b * wb + offset)
        pre = flatten(expand(pre, shape))
    out = bs.bootstrap(ck, pre, MU_1_8)
    return unflatten(out, shape)


def AND(ck, a, b):   return lincomb_bootstrap(ck, a, b, 1, 1, -MU_1_8)
def OR(ck, a, b):    return lincomb_bootstrap(ck, a, b, 1, 1, MU_1_8)
def NAND(ck, a, b):  return lincomb_bootstrap(ck, a, b, -1, -1, MU_1_8)
def NOR(ck, a, b):   return lincomb_bootstrap(ck, a, b, -1, -1, -MU_1_8)
def XOR(ck, a, b):   return lincomb_bootstrap(ck, a, b, 2, 2, MU_1_4)
def XNOR(ck, a, b):  return lincomb_bootstrap(ck, a, b, -2, -2, -MU_1_4)
def ANDNY(ck, a, b): return lincomb_bootstrap(ck, a, b, -1, 1, -MU_1_8)  # (not a) and b
def ANDYN(ck, a, b): return lincomb_bootstrap(ck, a, b, 1, -1, -MU_1_8)  # a and (not b)
def ORNY(ck, a, b):  return lincomb_bootstrap(ck, a, b, -1, 1, MU_1_8)   # (not a) or b
def ORYN(ck, a, b):  return lincomb_bootstrap(ck, a, b, 1, -1, MU_1_8)   # a or (not b)


def NOT(ck, a: lwe.Lwe) -> lwe.Lwe:
    """Free negation (no bootstrap)."""
    return -a


def COPY(ck, a: lwe.Lwe) -> lwe.Lwe:
    """Free copy (no bootstrap)."""
    return a


def CONSTANT(ck: CloudKey, value, shape=()) -> lwe.Lwe:
    """Trivial ciphertext of a constant bit (bootsCONSTANT): no bootstrap.

    value: 0/1 (int, array or tensor broadcastable to `shape`).
    """
    if isinstance(value, int):
        return lwe.trivial(MU_1_8 if value else -MU_1_8, ck.params.n, shape, ck.device)
    v = from_host(value, torch.int32, ck.device).expand(tuple(shape))
    mu = torch.where(v != 0, MU_1_8, -MU_1_8).to(torch.int32)
    return lwe.trivial(mu, ck.params.n, shape, ck.device)


def MUX(ck: CloudKey, a: lwe.Lwe, b: lwe.Lwe, c: lwe.Lwe) -> lwe.Lwe:
    """a ? b : c -- two bootstraps (no intermediate keyswitch) + one keyswitch."""
    with span("prepare"):
        shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
        a, b, c = (expand(x, shape) for x in (a, b, c))
        pre1 = (a + b).add_const(-MU_1_8)       # ~ a AND b
        pre2 = (c - a).add_const(-MU_1_8)       # ~ (not a) AND c
        both = lwe.concatenate([flatten(pre1), flatten(pre2)])
    a_ext, b_ext = bs.bootstrap_wo_ks(ck, both, MU_1_8)
    n = math.prod(shape)
    out = bs.keyswitch(ck, a_ext[:n] + a_ext[n:], b_ext[:n] + b_ext[n:] + MU_1_8)
    return unflatten(out, shape)


def encrypt_bits(gen: torch.Generator, sk, bits) -> lwe.Lwe:
    """bootsSymEncrypt, batched: bits (any shape of 0/1) -> Lwe of +-1/8."""
    bits = torch.as_tensor(bits, dtype=torch.int32, device=sk.device)
    mu = torch.where(bits != 0, MU_1_8, -MU_1_8).to(torch.int32)
    return lwe.encrypt(gen, sk.lwe_key, mu, sk.params.lwe_stdev)


def decrypt_bits(ct: lwe.Lwe, sk) -> torch.Tensor:
    """bootsSymDecrypt, batched: sign of phase."""
    return lwe.decrypt_bit(ct, sk.lwe_key)
