"""The plain 1:N identification (`reference.identify.identify_argmin`) against
known answers and against a loop over the definition.  Imports nothing of
the program."""

import numpy as np
import pytest

from perfbench.reference import identify, peba1


def loop_argmin(templates, probe, bitsize):
    """The definition, one slot at a time: |t - p| where the probe slot is
    nonzero, 2^bitsize - t (its low bitsize bits) where it is 0; squares
    summed mod 2^(3*bitsize - 1); the least sum, then its first index."""
    mod, mask = 1 << (3 * bitsize - 1), (1 << bitsize) - 1
    sums = []
    for t in templates:
        s = 0
        for tv, pv in zip(t, probe):
            d = ((1 << bitsize) - tv if pv == 0 else abs(int(tv) - int(pv))) & mask
            s += d * d
        sums.append(s % mod)
    least = min(sums)
    return least, sums.index(least)


def test_known_answers():
    assert identify.identify_argmin([[10, 20], [13, 16], [9, 21]], [12, 18], 8) == (5, 1)
    # A zero probe slot: 2^bitsize - template, a zero template slot under it 0.
    assert identify.identify_distances([[5], [0], [128]], [0], 8).tolist() == [251 ** 2, 0, 128 ** 2]
    # The 1:1 distance has the forced sign on the template's zeros instead.
    assert peba1.distance([5], [0], 8) == 25
    assert identify.one_to_one_distances([[5], [0], [128]], [0], 8).tolist() == [25, 0, 128 ** 2]
    assert identify.one_to_one_distances([[0]], [3], 8).tolist() == [253 ** 2]
    assert identify.identify_distances([[0]], [3], 8).tolist() == [9]


@pytest.mark.parametrize("bitsize,nslots", [(3, 2), (4, 5), (8, 128)])
def test_the_two_orders_differ_only_across_a_zero(bitsize, nslots):
    """The identification's and the 1:1 order give the same slot difference
    except where one side has a zero slot over a nonzero one other than
    2^(bitsize-1)."""
    rng = np.random.default_rng(2**33 + 17 * bitsize)
    half = 1 << (bitsize - 1)
    for _ in range(50):
        t = rng.integers(0, 1 << bitsize, nslots)
        p = rng.integers(0, 1 << bitsize, nslots)
        t[rng.random(nslots) < 0.2] = 0
        p[rng.random(nslots) < 0.2] = 0
        across = (((t == 0) & (p != 0) & (p != half)) | ((p == 0) & (t != 0) & (t != half)))
        same = ~across.any()
        d1 = identify.identify_distances(t[None], p, bitsize)[0]
        d2 = identify.one_to_one_distances(t[None], p, bitsize)[0]
        if same:
            assert d1 == d2
        one = peba1.slot_differences(p, t, bitsize) == peba1.slot_differences(t, p, bitsize)
        assert (one == ~across).all()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ties_go_to_the_lowest_index(n):
    templates = [[7, 7]] * n
    assert identify.identify_argmin(templates, [1, 1], 3) == (72 % 256, 0)
    templates = [[7, 7]] * (n - 1) + [[1, 2]]
    assert identify.identify_argmin(templates, [1, 1], 3)[1] == n - 1
    if n >= 2:
        templates = [[7, 7]] * (n - 2) + [[1, 2], [2, 1]]
        assert identify.identify_argmin(templates, [1, 1], 3) == (1, n - 2)


@pytest.mark.parametrize("bitsize,nslots", [(3, 2), (4, 5), (8, 128)])
def test_against_the_definition(bitsize, nslots):
    rng = np.random.default_rng(2**33 + bitsize)
    for _ in range(50):
        n = int(rng.integers(1, 9))
        t = rng.integers(0, 1 << bitsize, (n, nslots))
        p = rng.integers(0, 1 << bitsize, nslots)
        p[rng.random(nslots) < 0.2] = 0
        if n > 1 and rng.random() < 0.5:
            t[int(rng.integers(0, n))] = t[int(rng.integers(0, n))]
        assert identify.identify_argmin(t, p, bitsize) == loop_argmin(t.tolist(), p.tolist(),
                                                                   bitsize)
