"""The PyTorch port's parameters and package boundary against peba1_tpu."""

import dataclasses
import os
import subprocess
import sys

import pytest

from peba1_tpu import keys as jkeys
from peba1_tpu import params as jp
from peba1_tpu_torch import keys as tkeys
from peba1_tpu_torch import params as tp
from peba1_tpu_torch.ops import bootstrap as tbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jp.PRESETS))
def test_preset_fields_equal(name):
    assert dataclasses.asdict(tp.PRESETS[name]) == dataclasses.asdict(jp.PRESETS[name])


# The port's presets with no JAX twin (tests/test_torch_tfhers_bool.py holds
# them to the benchmark's plain reference instead).
PORT_ONLY = {"tfhers_bool_gen", "toy_tfhers_bool"}


def test_preset_names_and_protocol_equal():
    assert sorted(set(tp.PRESETS) - PORT_ONLY) == sorted(jp.PRESETS)
    assert PORT_ONLY <= set(tp.PRESETS)
    assert dataclasses.asdict(tp.PEBA1_PROTOCOL) == dataclasses.asdict(jp.PEBA1_PROTOCOL)
    p = tp.PRESETS["peba1_128_t2_gen"]
    assert (p.limb_plan, p.big_n, p.log2_2N) == (
        jp.PRESETS["peba1_128_t2_gen"].limb_plan, 1024, 10)


def test_import_leaves_jax_out():
    code = ("import sys, peba1_tpu_torch.protocol, peba1_tpu_torch.driver, "
            "peba1_tpu_torch.io.serial, peba1_tpu_torch.conformance, "
            "peba1_tpu_torch.sweep, peba1_tpu_torch.io.wire, "
            "peba1_tpu_torch.utils.logging, peba1_tpu_torch.utils.artifacts, "
            "peba1_tpu_torch.ops.cuda_kernels, peba1_tpu_torch.profiling; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'peba1_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


# The four use_fused_cmux configurations of scripts/diag.py:55-69.
DIAG_FUSED = {
    "l2_body3_fused": dataclasses.replace(tp.PEBA1_128, l=2, bgbit=8, bk_body_limbs=3,
                                          use_fused_cmux=True),
    "l2_body3_fused_k256": dataclasses.replace(tp.PEBA1_128, l=2, bgbit=8,
                                               bk_body_limbs=3, use_fused_cmux=True,
                                               amat_block=256),
    "l3_fused": dataclasses.replace(tp.PEBA1_128, use_fused_cmux=True),
    "t2_fused": dataclasses.replace(tp.PEBA1_128_T2, use_fused_step=False,
                                    use_pallas_rotate=False, use_fused_cmux=True),
}


def _params(name):
    if name == "fused_cmux":
        return dataclasses.replace(tp.PEBA1_128_T2_GENF, use_fused_cmux=True)
    return DIAG_FUSED[name] if name in DIAG_FUSED else tp.PRESETS[name]


@pytest.mark.parametrize("name,kernel", [
    ("peba1_128_t2_gen", "cmux_step_gen"), ("peba1_128_fast_gen", "cmux_step_gen"),
    ("ring_2048_gen", "cmux_step_gen"), ("peba1_128", None), ("ring_2048", None),
    ("toy", None), ("peba1_128_t2_genf", "blind_rotate_gen_full"),
    ("peba1_128_fast_genf", "blind_rotate_gen_full"),
    ("peba1_128_t2", "cmux_step"), ("peba1_128_fast", None), ("toy_fast", None),
    ("peba1_128_t2_stream", "cmux_step"), ("peba1_128_fast_stream", "cmux_step"),
    ("toy_t2", "cmux_step"), ("fused_cmux", "fused_blind_rotate"),
    ("l2_body3_fused", "fused_blind_rotate")])
def test_unported_kernel_follows_the_reference_branch_order(name, kernel):
    """ops/bootstrap.selected_kernel names the TPU kernel that peba1_tpu's
    blind_rotate would run (None: the plain scan of steps); every one is
    ported, so every configuration runs on the card."""
    assert tbs.selected_kernel(_params(name)) == kernel


@pytest.mark.parametrize("name", sorted(jp.PRESETS) + sorted(DIAG_FUSED))
def test_key_forms_follow_the_reference(name):
    """need_amat, need_w and active_bk_field: the JAX package's rules."""
    p = _params(name)
    jparams = jp.TfheParams(**dataclasses.asdict(p))
    assert tkeys.need_amat(p) == jkeys.need_amat(jparams)
    assert tkeys.need_w(p) == jkeys.need_w(jparams)
    assert tkeys.active_bk_field(p) == jkeys.active_bk_field(jparams)
