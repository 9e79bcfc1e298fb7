"""The narrow step of kernels 1 and 2 (``csrc/narrow_rotation.cuh``) on the CPU.

At `cuda_kernels.NARROW_MAX_ROWS` rows or fewer `cmux_step_gen` and
`blind_rotate_gen_full` launch their narrow instance: the Toeplitz weights
built in registers as the MMA's A operand, the batch rows its N operand.
Here: the path rule and its counter; `NarrowPlan`, the mirror of the
kernel's split of a step, covers every (output polynomial, 64-coefficient
tile, limb, digit polynomial, 128-byte span) exactly once on every grid;
one span's arithmetic as the kernel lays it out (a lane's window words as
its A registers, its digit words as they lie) is the Toeplitz product; the
header's constants are the mirror's.  The kernels themselves
are tested on the card by tests/test_torch_cuda.py.
"""

import collections
import re

import numpy as np
import pytest
import torch

from chip_smoke import cell_params
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.params import PRESETS

torch.set_num_threads(1)

T = ck.NARROW_MAX_ROWS
LATTICES = {"tfhe128_genf": cell_params()["peba1_tfhe128_genf"],
            "tfhers_bool_gen": PRESETS["tfhers_bool_gen"],
            "t2_gen": PRESETS["peba1_128_t2_gen"],
            "ring_2048_gen": PRESETS["ring_2048_gen"],
            "toy": PRESETS["toy"]}


def launch_entry(monkeypatch, kernel, B, p):
    """The C entry that `_launch_rotation` calls for `kernel` at B rows (the
    launch itself replaced)."""
    entries = []
    monkeypatch.setattr(ck, "_launch", lambda entry, device, *args: entries.append(entry))
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    acc = torch.zeros((B, (p.k + 1) * p.N), dtype=torch.int32)
    amt = torch.zeros((3, B), dtype=torch.int32)
    key = torch.zeros((2, G, C, 2 * p.N), dtype=torch.int8)
    tail = (7,) if kernel == "blind_rotate_gen_full" else ()
    ck._launch_rotation(kernel, acc, amt, key, p, 2, *tail)
    return entries[-1]


@pytest.mark.parametrize("B", [1, 2, 8, 9, 33, T, T + 1, 128, 1152])
@pytest.mark.parametrize("kernel", ck.BY_STAGE)
def test_the_narrow_entry_at_t_rows_or_fewer(monkeypatch, kernel, B):
    """Kernels 1 and 2 launch ``peba1_<kernel>_narrow`` at T rows or fewer
    and their ring instance above, at the cells' lattice."""
    entry = launch_entry(monkeypatch, kernel, B, LATTICES["tfhe128_genf"])
    assert entry == f"peba1_{kernel}" + ("_narrow" if B <= T else "")


def test_t_is_a_row_group_size_the_kernel_takes():
    """T rows round up to 8, 16 or 32, and both kernels have an instance of
    that many row groups of 8."""
    assert T in (8, 16, 32)
    groups = {8: 1, 16: 2, 32: 4}[T]
    for kernel in ck.BY_STAGE:
        src = (ck.CSRC / f"{kernel}_narrow.cu").read_text()
        assert f"case {groups}: return launch_narrow({kernel}_narrow_kernel<{groups}>" in src


def test_narrow_calls_counts_and_reset_clears(monkeypatch):
    """narrow_calls counts the narrow launches by kernel; launches counts
    every launch; reset_launches clears both."""
    p = LATTICES["tfhe128_genf"]
    ck.reset_launches()
    for kernel, B in [("blind_rotate_gen_full", 1), ("blind_rotate_gen_full", 64),
                      ("blind_rotate_gen_full", 512), ("cmux_step_gen", 8),
                      ("cmux_step_gen", 8192)]:
        launch_entry(monkeypatch, kernel, B, p)
    assert ck.narrow_calls == {"blind_rotate_gen_full": 1 + (64 <= T), "cmux_step_gen": 1}
    assert ck.launches["blind_rotate_gen_full"] == 3 and ck.launches["cmux_step_gen"] == 2
    ck.reset_launches()
    assert set(ck.narrow_calls.values()) == {0} and set(ck.launches.values()) == {0}


def test_a_recorded_window_numbers_narrow_calls_and_records_none(monkeypatch):
    """Inside record_phases a narrow call takes a call number and launches
    the narrow instance with nothing recorded."""
    p = LATTICES["tfhe128_genf"]
    with ck.record_phases(range(0, 2), calls=range(1, 2)) as rec:
        assert launch_entry(monkeypatch, "blind_rotate_gen_full", 1, p).endswith("_narrow")
        assert rec.seen == 1 and rec.launches == []


def every_unit(plan):
    """Each (o, tile's first coefficient, limb, g, kt) of a step, once."""
    KT, TJ, G = plan.N // 128, plan.N // 64, (plan.k + 1) * plan.l
    return collections.Counter((o, jt * 64, m, g, kt) for o in range(plan.k + 1)
                               for jt in range(TJ) for m in range(plan.limbs[o])
                               for g in range(G) for kt in range(KT))


def walked(plan):
    """The units of every warp of every block; checks that a block's 12
    warps run its list in order, cut into contiguous ranges."""
    seen = collections.Counter()
    for block in range(plan.grid):
        runs = [plan.warp_items(block, w) for w in range(ck.NARROW_WARPS)]
        assert [u for run in runs for u in run] == plan.items(block)
        seen.update(u for run in runs for u in run)
    return seen


@pytest.mark.parametrize("B", range(1, T + 1))
def test_the_narrow_split_covers_each_unit_once_at_toy(B):
    """At TOY every row count up to T over grids of 1 to 132 blocks: each
    unit once, and the blocks' spans as even as they can be."""
    p = LATTICES["toy"]
    want = every_unit(ck.NarrowPlan.of(B, p, 1))
    for grid in range(1, 133):
        plan = ck.NarrowPlan.of(B, p, grid)
        assert walked(plan) == want
        sizes = {len(plan.spans_of(b)) for b in range(grid)}
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("name", ["tfhe128_genf", "tfhers_bool_gen", "t2_gen"])
@pytest.mark.parametrize("B", [1, 9, 16, 17, T])
def test_the_narrow_split_covers_each_unit_once(name, B):
    """At the cells' lattices and t2_gen, on the H100's 132 blocks and on
    grids whose spans do not divide evenly: each unit once."""
    p = LATTICES[name]
    want = every_unit(ck.NarrowPlan.of(B, p, 1))
    for grid in (1, 7, 100, 131, 132):
        assert walked(ck.NarrowPlan.of(B, p, grid)) == want


def test_one_span_of_the_mma_sync_arithmetic_is_the_toeplitz_product():
    """One warp, one span, as the mma.sync path lays them out: lane (g, t)
    shifts the window words S[j] at byte 1 + g + 32t + 4j; for m16 tile u
    and chunk cc its A registers are S[4u+2cc], S[4u+2cc+2], S[4u+2cc+1],
    S[4u+2cc+3] and its B registers the digit words at bytes 32t + 8cc and
    32t + 8cc + 4 of row g, as they lie.  Their product is the Toeplitz
    product over the span's 128 bytes, for 64 coefficients."""
    rng = np.random.default_rng(4)
    window = rng.integers(-128, 128, 128 + 80).astype(np.int64)
    digits = rng.integers(-64, 64, (8, 128)).astype(np.int64)         # reversed order
    got = np.zeros((64, 8), np.int64)
    for cc in range(4):
        for u in range(4):
            a, b = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                s = [window[1 + g + 32 * t + 4 * j:][:4] for j in range(22)]
                j = 4 * u + 2 * cc
                a[g, 4 * t:4 * t + 4], a[g + 8, 4 * t:4 * t + 4] = s[j], s[j + 2]
                a[g, 16 + 4 * t:20 + 4 * t], a[g + 8, 16 + 4 * t:20 + 4 * t] = s[j + 1], s[j + 3]
                k = 32 * t + 8 * cc
                b[4 * t:4 * t + 4, g], b[16 + 4 * t:20 + 4 * t, g] = digits[g, k:k + 4], \
                    digits[g, k + 4:k + 8]
            got[16 * u:16 * u + 16] += a @ b
    toeplitz = np.array([[window[1 + x + k] for k in range(128)] for x in range(64)])
    assert np.array_equal(got, toeplitz @ digits.T)


def test_the_header_constants_are_the_mirror():
    """NARROW_WARPS, WIN_TAIL, SUM_STRIDE and the row groups of
    csrc/narrow_rotation.cuh are cuda_kernels'."""
    src = (ck.CSRC / "narrow_rotation.cuh").read_text()
    assert re.search(r"NARROW_WARPS = THREADS / 32;", src) and ck.NARROW_WARPS == 384 // 32
    assert int(re.search(r"WIN_TAIL = (\d+);", src).group(1)) == ck.NARROW_WIN_TAIL
    assert re.search(r"SUM_STRIDE = BN \+ (\d+);", src).group(1) == str(
        ck.NARROW_SUM_STRIDE - ck.BN_COLS)
    assert "return B <= 8 ? 1 : B <= 16 ? 2 : B <= 32 ? 4 : 0;" in src
