"""The roofline count: the kernel table's bound in PERF.md (PR 7's
`chip_smoke.py`) scaled to the configuration's published gadget and exact
key, at 8,192 rows; blind to the program's limb levers."""

import json

import pytest

from conftest import ROOT
from perfbench import roofline

TFHE = json.loads((ROOT / "perfbench" / "configs" / "peba1_tfhe128.json").read_text())["tfhe"]
# The kernel table's peba1_128_fast_genf step at B=8192: G = 4 digit rows
# (l=2) and C = 7 limbs (a 3-limb body).
TABLE_FAST_STEP_MS = 0.2430704078585144


def test_step_bound_is_the_tables_scaled_to_six_rows_and_eight_limbs():
    assert (TFHE["l"], TFHE["k"]) == (3, 1)
    want = TABLE_FAST_STEP_MS * (6 / 4) * (8 / 7)
    assert roofline.step_bound_s(TFHE, 8192) * 1e3 == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("body_limbs", [1, 3, 4])
def test_the_count_ignores_the_programs_limb_levers(body_limbs):
    lever = dict(TFHE, bk_body_limbs=body_limbs, bk_limbs=max(body_limbs, 3))
    assert roofline.call_bound_s(lever, 8192) == roofline.call_bound_s(TFHE, 8192)


def test_call_bound_is_operations_bound_at_8192_rows():
    bound, by = roofline.call_bound_s(TFHE, 8192)
    assert by == "operations"
    assert bound > TFHE["n"] * roofline.step_bound_s(TFHE, 8192)
    # The keyswitch adds under half a percent.
    assert bound < 1.005 * TFHE["n"] * roofline.step_bound_s(TFHE, 8192)


def test_the_formulation_is_read_from_the_kernels_in_the_trace():
    assert roofline.formulation_ran([["blind_rotate_gen_full_kernel", 1.0], ["gemm", 0.1]])
    assert not roofline.formulation_ran([["ntt_forward_kernel", 1.0], ["gemm", 0.1]])
    assert not roofline.formulation_ran([])
