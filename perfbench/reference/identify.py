"""Plain 1:N identification by argmin, on integers.

The reference PEBA1 (github.com/lab-incert/peba1) only compares one distance
with a bound; 1:N identification finds, of a probe and N templates, the
least distance and the lowest index that attains it.

Two orders of the slot difference.  The reference's 1:1 distance
(`peba1.distance(template, probe)`) forces the sign bit on the TEMPLATE's
zero slots: there a slot gives 2^bitsize - probe.  The identification
circuit subtracts the probe from each template, so it forces it on the
PROBE's zero slots: there a slot gives 2^bitsize - template.  The two
agree on every pair with no zero slot on either side, and on a zero under
a zero; they differ where one side has a zero slot over a nonzero one.
`identify_argmin` is the identification's order, the one the program
computes; `one_to_one_distances` is PEBA1's, for comparison.
"""

from __future__ import annotations

import numpy as np

from .peba1 import distance


def identify_distances(templates, probe, bitsize: int) -> np.ndarray:
    """(N,) distances of the probe (nslots,) to the templates (N, nslots) as
    the identification sums them: `peba1.distance` with the probe in the
    place of the template, so that a zero probe slot gives 2^bitsize -
    template."""
    return distance(np.asarray(probe)[None], templates, bitsize)


def one_to_one_distances(templates, probe, bitsize: int) -> np.ndarray:
    """(N,) distances of the probe to the templates in PEBA1's 1:1 order:
    `peba1.distance(template, probe)`, a zero template slot giving
    2^bitsize - probe."""
    return distance(templates, np.asarray(probe)[None], bitsize)


def identify_argmin(templates, probe, bitsize: int) -> "tuple[int, int]":
    """(least distance, lowest index that attains it) of the probe against
    the templates, by the definition: the minimum of `identify_distances`,
    then the first index where it occurs."""
    d = identify_distances(templates, probe, bitsize)
    least = int(d.min())
    return least, int(np.flatnonzero(d == least)[0])
