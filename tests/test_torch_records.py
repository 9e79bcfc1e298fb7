"""Pins of the port's committed records from the card (H100_*.json).

The noise campaigns are held to the JAX package's pin of its own campaigns
(tests/test_noise.py: at least 1e6 chained gates, no chain or decode error,
a Gaussian per-gate error bound below 1e-9, a margin of at least 6 sigma),
at the reference record's gate count, and their phase sigma to the
reference's sigma at the same parameters within 5%: about 6 standard errors
of a sigma estimated from 8,192 samples, plus the spread from one key to
another.  The other records are held to what their runs claimed.
"""

import glob
import json
import math
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
NOISE_PARAMS = ("peba1_128_fast_genf", "peba1_128_t2", "ring_2048_gen")


def load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def reference_campaigns():
    """The JAX package's committed campaigns (NOISE_*.json), by params."""
    recs = [load(os.path.basename(p)) for p in glob.glob(os.path.join(ROOT, "NOISE_*.json"))]
    return {r["params"]: r for r in recs}


def on_the_card(rec):
    assert rec["device"].startswith("NVIDIA H100") and rec["power_limit"].endswith(" W")


@pytest.mark.parametrize("params", NOISE_PARAMS)
def test_noise_campaign(params):
    rec = load(f"H100_NOISE_{params}.json")
    ref = reference_campaigns()[params]
    assert rec["params"] == params and rec["metric"] == ref["metric"]
    on_the_card(rec)
    assert rec["gates"] >= 10**6 and rec["gates"] == ref["gates"]
    assert rec["batch"] == ref["batch"] and rec["chain_steps"] == ref["chain_steps"]
    assert rec["chain_error_frac"] == 0.0
    assert rec["final_decode_errs"] == 0
    per_gate = math.erfc(rec["margin"] / rec["phase_sigma"] / math.sqrt(2))
    assert per_gate < 1e-9
    assert rec["margin_sigmas"] >= 6.0
    assert abs(rec["phase_sigma"] / ref["phase_sigma"] - 1) <= 0.05, (
        rec["phase_sigma"], ref["phase_sigma"])


def analytic_phase_sigma(p) -> float:
    """Phase sigma of a gate bootstrap's output after the keyswitch, over
    the samples of one key (what a campaign's `phase_sigma`, a standard
    deviation about the samples' mean, reads), as a fraction of the torus,
    from p's numbers and the port's decomposition: the keyswitching key's
    noise under k*N*t unsigned digits in [0, base), of variance
    (base^2 - 1)/12; the keyswitch's rounding to t*basebit bits, on the
    k*N/2 coefficients a binary key keeps; and the blind rotation's n
    external products: the bootstrapping key's noise under (k+1)*l*N signed
    digits of variance Bg^2/12, and the gadget's rounding to l*bgbit bits
    on 1 + k*N/2 coefficients."""
    kn, base = p.k * p.N, 1 << p.ks_basebit
    ks_key = kn * p.ks_t * (base * base - 1) / 12 * p.lwe_stdev ** 2
    ks_round = kn / 2 * 2.0 ** (-2 * p.ks_t * p.ks_basebit) / 12
    bk_key = p.n * (p.k + 1) * p.l * p.N * (1 << 2 * p.bgbit) / 12 * p.tlwe_stdev ** 2
    bk_round = p.n * (1 + kn / 2) * 2.0 ** (-2 * p.l * p.bgbit) / 12
    return math.sqrt(ks_key + ks_round + bk_key + bk_round)


def keyswitch_offset_sigma(p) -> float:
    """Spread over keys of the constant offset that unsigned keyswitch
    digits give one key's outputs: their mean (base - 1)/2 times the sum of
    the k*N*t noises of the keyswitching key.  A standard deviation over one
    key's samples does not see it; the margin must still hold it."""
    return math.sqrt(p.k * p.N * p.ks_t) * ((1 << p.ks_basebit) - 1) / 2 * p.lwe_stdev


def test_tfhers_bool_noise_campaign():
    """tfhe-rs's boolean default lattice has no JAX campaign: its campaign
    is held to the same pins at the committed campaigns' gate count, its
    sigma to the analytic one within 25%, and its margin, less three
    standard deviations of the key's offset, to 6 sigma."""
    from peba1_tpu_torch.params import PRESETS
    p = PRESETS["tfhers_bool_gen"]
    rec = load("H100_NOISE_tfhers_bool_gen.json")
    ref = reference_campaigns()["peba1_128_t2"]
    assert rec["params"] == "tfhers_bool_gen" and rec["metric"] == ref["metric"]
    on_the_card(rec)
    assert rec["gates"] >= 10**6 and rec["gates"] == ref["gates"]
    assert rec["batch"] == ref["batch"] and rec["chain_steps"] == ref["chain_steps"]
    assert rec["chain_error_frac"] == 0.0
    assert rec["final_decode_errs"] == 0
    per_gate = math.erfc(rec["margin"] / rec["phase_sigma"] / math.sqrt(2))
    assert per_gate < 1e-9
    assert rec["margin_sigmas"] >= 6.0
    sigma = analytic_phase_sigma(p)
    assert 0.0030 < sigma < 0.0032
    assert abs(rec["phase_sigma"] / sigma - 1) <= 0.25, (rec["phase_sigma"], sigma)
    offset = keyswitch_offset_sigma(p)
    assert (rec["margin"] - 3 * offset) / rec["phase_sigma"] >= 6.0


def test_bench_record():
    rec = load("H100_BENCH.json")
    assert [r["params"] for r in rec["runs"]] == [
        "peba1_128_t2_gen", "peba1_128_fast_genf", "peba1_128_t2"]
    for r in rec["runs"]:
        on_the_card(r)
        assert r["metric"] == "gate_bootstraps_per_s_per_chip"
        assert r["batch"] == 8192 and r["chain_lengths"] == [2, 10]
        assert r["batch_correct_frac"] == 1.0 and r["t_s2"] > r["t_s1"] > 0
        assert r["value"] == pytest.approx(8192 * 8 / (r["t_s2"] - r["t_s1"]))


def test_sweep_record():
    rec = load("H100_SWEEP.json")
    run, final = rec["resumed"], rec["finalize"]
    assert rec["interrupted"]["status"] == "interrupted"
    on_the_card(run)
    assert run["status"] == "complete" and run["resumed_from_disk"] >= 1
    assert run["n_templates"] == 128 and run["nslots"] == 128 and run["bitsize"] == 8
    assert run["decisions_verified"] == 128 and run["correct_frac"] == 1.0
    assert final["finalize_mode"] and final["finalize_device"] == "cpu"
    assert final["status"] == "complete" and final["decisions_verified"] == 128
    assert final["correct_frac"] == 1.0 and final["sk_device"] == "cpu"


def test_matches_record():
    rec = load("H100_BENCH_matches.json")
    for config in ("identify", "argmin", "pairs"):
        r = rec[config]
        on_the_card(r)
        assert r["metric"] == f"encrypted_{config}_matches_per_s"
        assert r["items"] == 64 and r["nslots"] == 128 and r["bitsize"] == 8
        assert r["correct_frac"] == 1.0 and r["peak_memory_bytes"] > 0


def test_sweep_1024_record():
    """The 1,024-template sweep at full width, in two calls (16 chunks, then
    the resume), finalized on the CPU: every decision right."""
    rec = load("H100_SWEEP_1024.json")
    first, run, final = rec["interrupted"], rec["resumed"], rec["finalize"]
    assert first["status"] == "interrupted" and first["chunks_done"] == 16
    for r in (first, run):
        on_the_card(r)
        assert r["n_templates"] == 1024 and r["nslots"] == 128 and r["bitsize"] == 8
        assert r["chunk"] == 32 and r["params"] == "peba1_128_t2_gen"
    assert run["status"] == "complete" and run["resumed_from_disk"] == 16
    assert run["computed_this_run"] == 16 and run["chunks_done"] == 32
    assert run["decisions_verified"] == 1024 and run["correct_frac"] == 1.0
    assert final["finalize_mode"] and final["finalize_device"] == "cpu"
    assert final["status"] == "complete" and final["decisions_verified"] == 1024
    assert final["correct_frac"] == 1.0 and final["sk_device"] == "cpu"


def test_scaling_record():
    """bench_scaling at size 1 on the card (bootstrap and identify at
    peba1_128_t2_gen, every result decrypted right), the comm model on the
    port's defaults, and the smoke's ring-TP share those defaults read."""
    rec = load("H100_SCALING.json")
    for mode in ("bootstrap", "identify"):
        r = rec[mode]
        on_the_card(r)
        assert r["metric"] == f"weak_scaling_efficiency_{mode}"
        assert r["params"] == "peba1_128_t2_gen" and r["backend"] == "nccl"
        assert set(r["times_s"]) == {"1"} and r["efficiency"] == {"1": 1.0}
        assert not r["virtual_cpu_mesh"] and r["times_s"]["1"] > 0
    assert rec["bootstrap"]["verified"]["1"] == 8192 * rec["bootstrap"]["reps"]
    ident = rec["identify"]
    assert ident["nslots"] == 128 and ident["bitsize"] == 8
    assert ident["verified"]["1"] == ident["per_device_templates"] * ident["reps"]
    share = rec["ringtp_share"]
    assert share["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and share["backend"] == "nccl"
    assert share["bootstrap"]["mismatches"] == 0 and share["bootstrap"]["launches"][
        "cmux_step_gen"] > 0
    assert [r["mismatches"] for r in share["ringtp"]] == [0, 0]
    assert 0 < share["ringtp_product_share"] < 1
    assert share["identify"]["b"] == share["identify"]["want_b"]
    comm = rec["comm"]
    assert comm["ringtp_gemm_frac"] == share["ringtp_product_share"]
    assert "H100_BENCH.json" in comm["batch_seconds_source"]
    assert "H100_SWEEP.json" in comm["template_seconds_source"]
