"""The port's bench and diagnostics tools against peba1_tpu, on the CPU.

`bench.chain` is held bit for bit to a JAX chain built from peba1_tpu as
the root bench.py builds it (bench.py:53-63), on carried keys and
ciphertexts; the tools' records to the keys of the JAX package's records.
Neither root bench.py nor scripts/diag.py is imported: both set JAX's
compilation cache when imported.
"""

import dataclasses
import functools
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import gates as jgates
from peba1_tpu import keys as jkeys
from peba1_tpu import lwe as jlwe
from peba1_tpu.ops import bootstrap as jbs
from peba1_tpu.params import TOY, TOY_NOISY, TOY_T2
from peba1_tpu_torch import bench, diag, keys, lwe
from peba1_tpu_torch import conformance as cf

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The keys of root bench.py's JSON line (bench.py:107-120).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "chain_lengths",
              "ms_per_batch", "t_s1", "t_s2", "batch_correct_frac", "params", "device"}


@functools.partial(jax.jit, static_argnames=("steps",))
def jax_chain(ck, a, b, steps):
    """`steps` serialized identity bootstraps AND(x, x) = x, as bench.py."""

    def body(c, _):
        pre = jlwe.Lwe(c[0] * 2, c[1] * 2 + jnp.int32(-jgates.MU_1_8))
        out = jbs.bootstrap(ck, pre, jnp.int32(jgates.MU_1_8))
        return (out.a, out.b), ()

    (a, b), _ = jax.lax.scan(body, (a, b), None, length=steps)
    return a, b


def plain(p):
    """p without the Pallas kernels (the reference's plain configuration)."""
    return dataclasses.replace(p, use_pallas_rotate=False, use_pallas_extprod=False,
                               use_fused_step=False)


@pytest.mark.parametrize("p", [TOY, TOY_T2], ids=["toy", "toy_t2"])
def test_chain_matches_the_jax_chain(p):
    sk, ck = jkeys.keygen(jax.random.PRNGKey(5), p)
    bits = np.random.default_rng(6).integers(0, 2, 24)
    ct = jgates.encrypt_bits(jax.random.PRNGKey(7), sk, jnp.asarray(bits))
    want = jax_chain(ck.replace(params=plain(p)), ct.a, ct.b, steps=3)
    tck = keys.cloud_key_from_numpy(p, np.asarray(ck.bk_tp), np.asarray(ck.ks_table_limbs),
                                    "cpu")
    got = bench.chain(tck, lwe.Lwe(torch.as_tensor(np.asarray(ct.a)),
                                   torch.as_tensor(np.asarray(ct.b))), 3)
    np.testing.assert_array_equal(np.asarray(want[0]), got.a.numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got.b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jlwe.decrypt_bit(jlwe.Lwe(*want), sk.lwe_key)), bits)


def test_bench_main_prints_the_bench_record(capsys):
    rec = bench.main(["--params", "toy", "--batch", "32", "--s1", "1", "--s2", "2",
                      "--reps", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert set(rec) == BENCH_KEYS | {"power_limit"}
    assert rec["metric"] == "gate_bootstraps_per_s_per_chip"
    assert rec["batch_correct_frac"] == 1.0 and rec["chain_lengths"] == [1, 2]
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["value"] == pytest.approx(32 / (rec["t_s2"] - rec["t_s1"]))


def test_bench_settings_from_the_environment(monkeypatch):
    monkeypatch.setenv("PEBA1_BENCH_BATCH", "64")
    monkeypatch.setenv("PEBA1_BENCH_S1", "3")
    monkeypatch.setenv("PEBA1_BENCH_S2", "5")
    monkeypatch.setenv("PEBA1_BENCH_REPS", "4")
    monkeypatch.setenv("PEBA1_BENCH_PARAMS", "toy_t2")
    args = bench.parse_args(["--s2", "7"])
    assert (args.batch, args.s1, args.s2, args.reps, args.params, args.device) == (
        64, 3, 7, 4, "toy_t2", "cuda")
    with pytest.raises(SystemExit):
        bench.parse_args(["--s1", "2", "--s2", "2"])


def test_campaign_record_and_its_checkpoint(monkeypatch, tmp_path):
    written = []
    real = diag.atomic_json
    monkeypatch.setattr(diag, "atomic_json",
                        lambda path, obj, **kw: (written.append(dict(obj)), real(path, obj, **kw)))
    out = tmp_path / "noise.json"
    rec = diag.main(["campaign", "--params", "toy_noisy", "--batch", "32", "--steps", "17",
                     "--chunk-steps", "1", "--device", "cpu", "--out", str(out)])
    with open(ROOT / "NOISE_r05_fast.json") as f:
        reference = json.load(f)
    assert set(rec) == set(reference) | {"power_limit"}
    assert json.loads(out.read_text()) == rec
    assert rec["chain_error_frac"] == 0.0 and rec["final_decode_errs"] == 0
    assert rec["gates"] == 32 * 17 and rec["chain_steps"] == 17
    # a valid partial record after 16 chunks, then the final one
    assert [w["chain_steps"] for w in written] == [16, 17]
    assert set(written[0]) == set(rec) and written[0]["chain_error_frac"] == 0.0
    assert 0 < rec["phase_sigma"] < rec["margin"] / 6


def test_phase_err_matches_the_jax_formula():
    sk, _ = jkeys.keygen(jax.random.PRNGKey(8), TOY_NOISY)
    bits = np.random.default_rng(9).integers(0, 2, 200)
    ct = jgates.encrypt_bits(jax.random.PRNGKey(10), sk, jnp.asarray(bits))
    phase = np.asarray(jlwe.phase(ct, sk.lwe_key)).astype(np.int64) & 0xFFFFFFFF
    want = (phase - np.where(bits == 1, jgates.MU_1_8, (-jgates.MU_1_8) & 0xFFFFFFFF)) \
        & 0xFFFFFFFF
    want = np.where(want >= 2**31, want - 2**32, want).astype(np.float64) / 2**32
    got = diag._phase_err(torch.as_tensor(np.asarray(ct.a)), torch.as_tensor(np.asarray(ct.b)),
                          torch.as_tensor(np.asarray(sk.lwe_key)), torch.as_tensor(bits))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0


def test_golden_on_a_small_corpus(tmp_path):
    corpus = tmp_path / "corpus.json"
    cf.save_corpus(str(corpus), cf.make_corpus(4, nslots=2, bitsize=2, seed=1))
    out = tmp_path / "golden.json"
    rec = diag.main(["golden", "--params", "toy", "--corpus", str(corpus),
                     "--device", "cpu", "--out", str(out)])
    assert rec["all_equal"] and rec["b_equal"] == rec["y_equal"] == rec["n_cases"] == 4
    assert json.loads(out.read_text()) == rec


def test_throughput_configs_are_the_reference_lever_matrix():
    """CONFIGS carries scripts/diag.py's lever matrix: the same names, each
    with the same field values (the JAX block evaluated on peba1_tpu's
    presets, without importing the script)."""
    from peba1_tpu.params import PEBA1_128, PRESETS
    src = (ROOT / "scripts" / "diag.py").read_text()
    block = src[src.index("CONFIGS = {"):]
    block = block[:block.index("\n}\n") + 3]
    scope = {"dataclasses": dataclasses, "PEBA1_128": PEBA1_128, "PRESETS": PRESETS}
    exec(block, scope)
    assert list(diag.CONFIGS) == list(scope["CONFIGS"])
    for name, p in diag.CONFIGS.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(scope["CONFIGS"][name]), name


def test_the_port_imports_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|peba1_tpu)\b", re.M)
    sources = sorted((ROOT / "peba1_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 30
    for path in sources:
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize("kernel", ["cmux_step_gen", "blind_rotate_gen_full", "rotate_decompose",
                                    "cmux_step", "extprod_recombine", "fused_blind_rotate"])
def test_the_smoke_cites_the_def_line_of_each_tpu_kernel(kernel):
    """The kernels line's `replaces` names the line of the Pallas kernel's def."""
    from chip_smoke import KERNELS
    path, line = KERNELS[kernel][1].rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith(f"def {kernel}("), text
