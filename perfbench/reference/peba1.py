"""Plain PEBA1 decision and nonce proof, on integers.

The protocol of the PEBA1 reference (github.com/lab-incert/peba1,
src/Math.cpp and src/main.cpp), as its gate circuits compute it, quirks
included:
  * the slot difference is |probe - template| on bitsize+1 bits, except
    that a template slot of 0 gives 2^bitsize - probe (its two's complement
    of 0 forces the sign bit), and the square reads the low bitsize bits;
  * the squares are summed on 3*bitsize - 1 bits (mod 2^(3*bitsize-1));
  * b = [ED > bound], the decision word b zero-extended to 3*bitsize bits;
  * y = r1 where b = 1 and (2^bitsize - 1) * r0 = -r0 mod 2^bitsize where
    b = 0 (1 - b is computed by the same subtraction, 0 - 0 giving
    2^bitsize - 1);
  * the server's check y == r1 holds where ED exceeds the bound, so the
    match verdict is its negation.
"""

from __future__ import annotations

import numpy as np


def slot_differences(template, probe, bitsize: int) -> np.ndarray:
    """The low `bitsize` bits of the circuit's |probe - template| per slot."""
    t = np.asarray(template, np.int64)
    p = np.asarray(probe, np.int64)
    diff = np.where(t == 0, (1 << bitsize) - p, np.abs(p - t))
    return diff & ((1 << bitsize) - 1)


def distance(template, probe, bitsize: int) -> np.ndarray:
    """Squared Euclidean distance over the last axis, as the circuit sums it."""
    d = slot_differences(template, probe, bitsize)
    return (d * d).sum(axis=-1) % (1 << (3 * bitsize - 1))


def decision(template, probe, bound: int, bitsize: int) -> np.ndarray:
    """b = 1 where the distance exceeds the bound (no match)."""
    return (distance(template, probe, bitsize) > bound).astype(np.int64)


def decision_word(b, bitsize: int) -> np.ndarray:
    """b zero-extended to 3*bitsize bits, least significant bit first."""
    b = np.asarray(b, np.int64)
    word = np.zeros(b.shape + (3 * bitsize,), np.int64)
    word[..., 0] = b
    return word


def blinded_nonce(b, r0, r1, bitsize: int) -> np.ndarray:
    """y = r1 where b = 1, -r0 mod 2^bitsize where b = 0."""
    mod = 1 << bitsize
    return np.where(np.asarray(b) == 1, np.asarray(r1) % mod, (-np.asarray(r0)) % mod)


def verdicts(y, r1) -> dict:
    """The server's verdicts from the client's proof y."""
    ref = np.asarray(y) == np.asarray(r1)
    return {"reference_verdict": ref, "is_match": ~ref}
