"""The PyTorch port's parameters and package boundary against peba1_tpu."""

import dataclasses
import os
import subprocess
import sys

import pytest

from peba1_tpu import params as jp
from peba1_tpu_torch import params as tp
from peba1_tpu_torch.ops import bootstrap as tbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jp.PRESETS))
def test_preset_fields_equal(name):
    assert dataclasses.asdict(tp.PRESETS[name]) == dataclasses.asdict(jp.PRESETS[name])


def test_preset_names_and_protocol_equal():
    assert sorted(tp.PRESETS) == sorted(jp.PRESETS)
    assert dataclasses.asdict(tp.PEBA1_PROTOCOL) == dataclasses.asdict(jp.PEBA1_PROTOCOL)
    p = tp.PRESETS["peba1_128_t2_gen"]
    assert (p.limb_plan, p.big_n, p.log2_2N) == (
        jp.PRESETS["peba1_128_t2_gen"].limb_plan, 1024, 10)


def test_import_leaves_jax_out():
    code = ("import sys, peba1_tpu_torch.protocol, peba1_tpu_torch.driver, "
            "peba1_tpu_torch.io.serial, peba1_tpu_torch.conformance; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'peba1_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("name,kernel", [
    ("peba1_128_t2_gen", None), ("peba1_128_fast_gen", None),
    ("ring_2048_gen", None), ("peba1_128", None), ("ring_2048", None),
    ("toy", None), ("peba1_128_t2_genf", None), ("peba1_128_fast_genf", None),
    ("peba1_128_t2", None), ("peba1_128_fast", None), ("toy_fast", None),
    ("peba1_128_t2_stream", None), ("peba1_128_fast_stream", None),
    ("toy_t2", None), ("fused_cmux", "fused_blind_rotate")])
def test_unported_kernel_follows_the_reference_branch_order(name, kernel):
    """On the card a preset runs only where its kernel is ported; the kernel
    named is the one peba1_tpu's blind_rotate would select.  Only
    use_fused_cmux, which no preset sets, selects one that is not."""
    p = (dataclasses.replace(tp.PEBA1_128_T2_GENF, use_fused_cmux=True)
         if name == "fused_cmux" else tp.PRESETS[name])
    assert tbs.unported_kernel(p) == kernel
