"""Levelized bit-serial arithmetic circuits over bit-sliced ciphertexts.

Counterpart of ``peba1_tpu/circuits.py``, the same levelized gate schedules:
all gates at the same circuit depth execute as one bootstrap launch, and
vector loops over embedding slots become batch dimensions.

Values are "bit words": backend bit-tensors with the LSB-first bit axis LAST,
shape (..., nbits).  Leading dims are batch (protocol instances, slots, ...).

Conformance notes (reference quirks preserved):
  * sub_abs computes |a - b| (not signed a-b), on nbits+1 bits;
  * multiply uses a hard-coded `length`-wide accumulator with the final
    ripple add on length-1 bits;
  * minimum's compare bit is 1 iff a > b, zero-extended to a full word;
  * manhattan accumulates on only `bitsize` bits and therefore overflows for
    distances >= 2^bitsize, faithfully;
  * NOT/COPY/CONSTANT and shifts are bootstrap-free.

Deviations: slot accumulations use a log-depth balanced tree instead of a
serial chain -- addition mod 2^W is associative, so result bits are
identical -- and Function_f's accumulator is zero-initialized.

``argmin_counts`` counts the bootstrap calls and bootstraps of every
`argmin_tree` since `reset_argmin_counts`, from the operands' shapes
(``backends.Tally``); no other circuit counts.
"""

from __future__ import annotations

import numpy as np
import torch

from .backends import Tally

# The tournament's bootstrap calls and bootstraps (a MUX is two).
argmin_counts = {"calls": 0, "bootstraps": 0}


def reset_argmin_counts() -> None:
    for name in argmin_counts:
        argmin_counts[name] = 0


# --------------------------------------------------------------------------
# bit-word helpers
# --------------------------------------------------------------------------

def const_word(be, value, nbits: int, shape=()):
    """Trivial (bootstrap-free) encryption of an integer, LSB-first bits."""
    shape = tuple(shape)
    value = np.asarray(value, np.int64)
    bits = (value[..., None] >> np.arange(nbits)) & 1
    bits = np.ascontiguousarray(np.broadcast_to(bits, shape + (nbits,)), np.int32)
    return be.CONSTANT(bits, shape + (nbits,))


def word_bits(x) -> int:
    return x.shape[-1]


# --------------------------------------------------------------------------
# C3: 1-bit full adder -- 7 gates in 3 levels (vs the reference's serial 7,
# src/Math.cpp:27-50: sum = a^b^c, carry' = ab ^ ac ^ cb)
# --------------------------------------------------------------------------

def add1(be, a, b, c):
    """(sum, carry_out) of single-bit inputs, arbitrary batch shape."""
    s1, ab, ac, cb = be.level([("XOR", a, b), ("AND", a, b), ("AND", a, c), ("AND", c, b)])
    s, q = be.level([("XOR", s1, c), ("XOR", ab, ac)])
    cout = be.XOR(q, cb)
    return s, cout


# --------------------------------------------------------------------------
# C4: N-bit ripple adder (src/Math.cpp:54-67)
# --------------------------------------------------------------------------

def add_n(be, a, b, nbits: int | None = None, carry_in=None):
    """(sum (..., nbits), carry_out (...,)). Reads the low nbits of a and b."""
    if nbits is None:
        nbits = word_bits(a)
    shape = torch.broadcast_shapes(a[..., 0].shape, b[..., 0].shape)
    c = be.CONSTANT(0, shape) if carry_in is None else carry_in
    outs = []
    for i in range(nbits):
        s, c = add1(be, a[..., i], b[..., i], c)
        outs.append(s)
    return be.stack(outs, axis=-1), c


# --------------------------------------------------------------------------
# C5: two's complement (src/Math.cpp:71-93): flip bits (free NOT), add 1
# --------------------------------------------------------------------------

def twos_complement(be, a, nbits: int | None = None):
    if nbits is None:
        nbits = word_bits(a)
    flipped = be.NOT(a[..., :nbits])
    one = const_word(be, 1, nbits, a[..., 0].shape)
    s, _ = add_n(be, flipped, one, nbits)
    return s


# --------------------------------------------------------------------------
# C6: absolute value (src/Math.cpp:97-119): sign-mask add-then-XOR
# --------------------------------------------------------------------------

def abs_n(be, a, nbits: int | None = None):
    if nbits is None:
        nbits = word_bits(a)
    sign = a[..., nbits - 1 : nbits]  # keep bit axis for broadcast
    mask = be.concat([sign] * nbits, axis=-1)
    tmp, _ = add_n(be, a, mask, nbits)
    return be.XOR(tmp, mask)  # one batched launch over all bits


# --------------------------------------------------------------------------
# C7: |a - b| on nbits+1 bits (src/Math.cpp:123-180)
# --------------------------------------------------------------------------

def sub_abs(be, a, b, nbits: int | None = None):
    """|a - b| where a, b are nbits-wide non-negative words -> nbits+1 bits.

    Faithful reference quirk: for b == 0 the result is 2^nbits - a, not a.
    The reference unconditionally forces the sign bit of -b to 1
    ("the 9th bit is 1 as it is a negative number", src/Math.cpp:138), which
    is wrong for b = 0; the code, not the comment, is the conformance target
    (SURVEY.md section 3.2).
    """
    if nbits is None:
        nbits = word_bits(a)
    shape = torch.broadcast_shapes(a[..., 0].shape, b[..., 0].shape)
    zero = be.CONSTANT(0, shape + (1,))
    one = be.CONSTANT(1, shape + (1,))
    # a_long: a zero-extended to nbits+1 (sign bit 0: a is non-negative)
    a_long = be.concat([a[..., :nbits], zero], axis=-1)
    # 2's complement of b on nbits bits, then sign bit forced to 1
    b2 = twos_complement(be, b, nbits)
    b2_long = be.concat([b2, one], axis=-1)
    tmp, carry = add_n(be, a_long, b2_long, nbits + 1)
    # Branch-free select: carry==1 -> tmp is the (positive) result;
    # carry==0 -> result is 2's complement of tmp.
    carry_w = be.stack([carry] * (nbits + 1), axis=-1)
    t_pos = be.AND(tmp, carry_w)          # tmp && var      (batched)
    t_neg_in = be.ANDNY(carry_w, tmp)     # tmp && NOT(var) (batched, fused NOT)
    t_neg = twos_complement(be, t_neg_in, nbits + 1)
    return be.OR(t_neg, t_pos)


# --------------------------------------------------------------------------
# C8: shifts by a constant -- bootstrap-free (src/Math.cpp:183-211; dead code
# in the reference but part of its public header API, include/Math.h:18-20)
# --------------------------------------------------------------------------

def shift_left(be, a, nbits: int, n: int):
    zero = be.CONSTANT(0, a[..., 0].shape + (n,))
    return be.concat([zero, a[..., : nbits - n]], axis=-1)


def shift_right(be, a, nbits: int, n: int):
    zero = be.CONSTANT(0, a[..., 0].shape + (n,))
    return be.concat([a[..., n:nbits], zero], axis=-1)


# --------------------------------------------------------------------------
# C9: schoolbook multiplier with fixed-width accumulator
# (src/Math.cpp:214-250: length=23 hard-coded, final add on length-1 bits)
# --------------------------------------------------------------------------

def multiply(be, a, b, nbits: int | None = None, length: int = 23):
    if nbits is None:
        nbits = word_bits(a)
    shape = torch.broadcast_shapes(a[..., 0].shape, b[..., 0].shape)
    final = const_word(be, 0, length, shape)
    for i in range(nbits):
        # Partial product row: (a & b_i) shifted left by i, zero elsewhere.
        bi = b[..., i : i + 1]
        row_bits = be.AND(a[..., :nbits], be.concat([bi] * nbits, axis=-1))
        zeros_lo = be.CONSTANT(0, shape + (i,))
        zeros_hi = be.CONSTANT(0, shape + (length - nbits - i,))
        row = be.concat([zeros_lo, row_bits, zeros_hi], axis=-1)
        s, _ = add_n(be, row, final, length - 1)
        final = be.concat([s, final[..., length - 1 :]], axis=-1)
    return final


# --------------------------------------------------------------------------
# C10: comparator / minimum (src/Math.cpp:259-286)
# --------------------------------------------------------------------------

def compare_bit(be, a, b, lsb_carry):
    """r = (a == b) ? lsb_carry : a  -- one XNOR + one MUX."""
    eq = be.XNOR(a, b)
    return be.MUX(eq, lsb_carry, a)


def compare_gt(be, a, b, nbits: int | None = None):
    """Bare compare bit r = [a > b] (0 on equality).

    The reference's compare_bit recurrence r <- (a_i == b_i) ? r : a_i
    scanned LSB-first (src/Math.cpp:259-262,271-273): the final r is a's bit
    at the highest differing position.
    """
    if nbits is None:
        nbits = word_bits(a)
    shape = torch.broadcast_shapes(a[..., 0].shape, b[..., 0].shape)
    r = be.CONSTANT(0, shape)
    # XNORs of all bit positions can fuse into one launch; the MUX chain is
    # inherently serial (carry recurrence).
    eq = be.XNOR(a[..., :nbits], b[..., :nbits])
    for i in range(nbits):
        r = be.MUX(eq[..., i], r, a[..., i])
    return r


def minimum(be, a, b, nbits: int | None = None):
    """Returns (min(a,b), bit_word) where bit = 1 iff a > b, zero-extended.

    Polarity: the reference's in-code comment claims the opposite; the code
    is the truth (SURVEY.md section 3.2 discrepancy #2).
    """
    if nbits is None:
        nbits = word_bits(a)
    shape = torch.broadcast_shapes(a[..., 0].shape, b[..., 0].shape)
    r = compare_gt(be, a, b, nbits)
    r_w = be.stack([r] * nbits, axis=-1)
    mn = be.MUX(r_w, b[..., :nbits], a[..., :nbits])  # one batched MUX launch
    zeros = be.CONSTANT(0, shape + (nbits - 1,))
    bit_word = be.concat([be.stack([r], axis=-1), zeros], axis=-1)
    return mn, bit_word


def argmin_tree(be, vals, idxs, nbits: int | None = None):
    """Encrypted tournament argmin along axis 0 (1:N identification core).

    Lifts the reference's compare/minimum building block
    (src/Math.cpp:259-286) to an index-carrying log-depth reduction -- the
    "bootstrapped argmin" of BASELINE.json config 3 (the reference itself
    only ever compares one distance against a bound).

    vals: (M, ..., W) bit-words; idxs: (M, ..., I) bit-words.
    Returns (min_val (..., nbits), min_idx (..., I)).  Ties pick the LOWER
    index: the compare bit is 0 on equality, selecting the left (earlier)
    element, and each round pairs neighbors in order.  Its calls are
    counted in `argmin_counts`.
    """
    be = Tally(be, argmin_counts)
    if nbits is None:
        nbits = word_bits(vals)
    ibits = word_bits(idxs)
    vals = vals[..., :nbits]
    m = vals.shape[0]
    while m > 1:
        half = m // 2
        a_v, b_v = vals[0:2 * half:2], vals[1:2 * half:2]
        a_i, b_i = idxs[0:2 * half:2], idxs[1:2 * half:2]
        r = compare_gt(be, a_v, b_v, nbits)           # (half, ...) = [a > b]
        new_v = be.MUX(be.stack([r] * nbits, axis=-1), b_v, a_v)
        new_i = be.MUX(be.stack([r] * ibits, axis=-1), b_i, a_i)
        if m % 2:  # odd element gets a bye into the next round
            new_v = be.concat([new_v, vals[2 * half:]], axis=0)
            new_i = be.concat([new_i, idxs[2 * half:]], axis=0)
        vals, idxs = new_v, new_i
        m = half + (m % 2)
    return vals[0], idxs[0]


# --------------------------------------------------------------------------
# tree reduction over the slot axis (replaces the reference's serial
# accumulation; mod-2^W addition is associative so bits are identical)
# --------------------------------------------------------------------------

def tree_sum(be, words, width: int):
    """words: (..., nslots, W) -> (..., W): sum over slots mod 2^width.

    Bits at positions >= width (if any) of the output are constant zeros.
    """
    W = word_bits(words)
    while words.shape[-2] > 1:
        m = words.shape[-2]
        if m % 2:  # pad with a zero word (additive identity)
            pad = be.CONSTANT(0, words[..., 0, :].shape[:-1] + (1, W))
            words = be.concat([words, pad], axis=-2)
            m += 1
        lhs, rhs = words[..., 0::2, :], words[..., 1::2, :]
        s, _ = add_n(be, lhs, rhs, width)
        if width < W:
            zeros = be.CONSTANT(0, s[..., 0].shape + (W - width,))
            s = be.concat([s, zeros], axis=-1)
        words = s
    return words[..., 0, :]


# --------------------------------------------------------------------------
# C11: Manhattan distance (src/Math.cpp:294-327) -- bitsize-wide accumulator
# (documented overflow for distances >= 2^bitsize)
# --------------------------------------------------------------------------

def _check_slots(a, b, op: str) -> None:
    """Real error where the reference perror()s and carries on
    (src/Math.cpp:295-300,334-339 print 'size mismatch' without aborting)."""
    if a.shape[-2] != b.shape[-2]:
        raise ValueError(
            f"{op}: slot-count mismatch {a.shape[-2]} vs {b.shape[-2]}")
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(
            f"{op}: bit-width mismatch {a.shape[-1]} vs {b.shape[-1]}")


def manhattan(be, a, b, bitsize: int | None = None):
    """a, b: (..., nslots, bitsize) -> (..., bitsize+1); top bit constant 0."""
    if bitsize is None:
        bitsize = word_bits(a)
    _check_slots(a, b, "manhattan")
    diffs = sub_abs(be, b, a, bitsize)  # (..., nslots, bitsize+1), all slots at once
    total = tree_sum(be, diffs, width=bitsize)  # only low `bitsize` bits accumulate
    return total


# --------------------------------------------------------------------------
# C12: squared Euclidean distance (src/Math.cpp:333-369)
# --------------------------------------------------------------------------

def euclidean(be, a, b, bitsize: int | None = None, max_bitsize: int = 24):
    """a, b: (..., nslots, bitsize) -> (..., max_bitsize); top bit constant 0.

    Per slot: |b_i - a_i| (nbits+1 wide), squared via the hard-coded
    `bitsize`-input multiplier into a max_bitsize-1-wide accumulator
    (reference uses low 8 bits of the 9-bit diff, src/Math.cpp:356).
    """
    if bitsize is None:
        bitsize = word_bits(a)
    _check_slots(a, b, "euclidean")
    diffs = sub_abs(be, b, a, bitsize)               # (..., nslots, bitsize+1)
    squares = multiply(be, diffs[..., :bitsize], diffs[..., :bitsize],
                       bitsize, length=max_bitsize - 1)
    total = tree_sum(be, squares, width=max_bitsize - 1)
    zero = be.CONSTANT(0, total[..., 0].shape + (1,))
    return be.concat([total, zero], axis=-1)


# --------------------------------------------------------------------------
# C13/C14: protocol functions f and g (src/Math.cpp:379-417)
# --------------------------------------------------------------------------

def function_f(be, probe, template, bound, bitsize: int | None = None):
    """b = [ED(probe, template) > bound], zero-extended to 3*bitsize bits.

    probe/template: (..., nslots, bitsize); bound: (..., 3*bitsize).
    The reference's `ed` accumulator is uninitialized (src/Math.cpp:381);
    here it is defined as zero (documented deviation).
    """
    if bitsize is None:
        bitsize = word_bits(probe)
    if word_bits(bound) != 3 * bitsize:
        raise ValueError(
            f"function_f: bound must be {3 * bitsize} bits wide "
            f"(got {word_bits(bound)}); the reference compares on "
            "3*bitsize bits (src/Math.cpp:381-384)")
    ed = euclidean(be, template, probe, bitsize, max_bitsize=3 * bitsize)
    _, bit_word = minimum(be, ed, bound, 3 * bitsize)
    return bit_word


def function_g(be, b_word, r0, r1, bitsize: int | None = None):
    """y = (1 - b) * r0 + b * r1, on `bitsize` bits (src/Math.cpp:390-417).

    Faithful semantics: for b == 1, y = r1; for b == 0, the reference's
    sub_abs(1, 0) quirk makes (1 - b) evaluate to 2^bitsize - 1, so
    y = (2^bitsize - 1) * r0 mod 2^bitsize = -r0 mod 2^bitsize -- NOT r0.
    Combined with Function_f's polarity (b = 1 iff ed > bound), the driver's
    y == r1 check succeeds exactly when the distance EXCEEDS the bound
    (SURVEY.md section 3.2 discrepancy #3, reproduced at the gate level).
    """
    if bitsize is None:
        bitsize = word_bits(r0)
    shape = b_word[..., 0].shape
    one = const_word(be, 1, bitsize, shape)
    # (1 - b): reference reuses |a-b| with a=1 (low `bitsize` bits kept; the
    # reference even overflows its 8-slot buffer writing 9 bits -- we take
    # the low bitsize, which is what its later reads use).
    not_b = sub_abs(be, one, b_word[..., :bitsize], bitsize)[..., :bitsize]
    t0 = multiply(be, not_b, r0, bitsize, length=3 * bitsize)[..., :bitsize]
    t1 = multiply(be, b_word[..., :bitsize], r1, bitsize, length=3 * bitsize)
    y, _ = add_n(be, t0, t1, bitsize)
    return y
