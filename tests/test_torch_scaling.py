"""python -m peba1_tpu_torch.bench_scaling on the CPU: the comm model's
record and its defaults (the port's own records on the card, never the
TPU's), and weak scaling over gloo worlds of 1 and 2 CPU ranks at toy size.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from peba1_tpu_torch import bench_scaling

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def test_comm_defaults_come_from_the_port_records():
    bench = next(r for r in load("H100_BENCH.json")["runs"]
                 if r["params"] == "peba1_128_t2_gen")
    sweep = load("H100_SWEEP.json")["resumed"]
    smoke = load("H100_SCALING.json")["ringtp_share"]
    args = bench_scaling.parse_args(["--mode", "comm"])
    assert args.params == "peba1_128_t2_gen" and args.comm_batch == bench["batch"]
    assert args.batch_seconds == pytest.approx(bench["batch"] / bench["value"], rel=1e-6)
    assert args.template_seconds == pytest.approx(1 / sweep["templates_per_s_steady"])
    assert args.ringtp_gemm_frac == pytest.approx(smoke["ringtp_product_share"])
    for source in (args.batch_seconds_source, args.template_seconds_source,
                   args.ringtp_gemm_frac_source):
        assert "H100" in source and "700.00 W" in source
    for rec in (bench, sweep):
        assert rec["device"] == "NVIDIA H100 80GB HBM3" and rec["power_limit"] == "700.00 W"
    assert args.nvlink_gbps == 450.0 and "assumed" in bench_scaling.NVLINK_SOURCE


def test_comm_record(tmp_path):
    out = tmp_path / "comm.json"
    rec = bench_scaling.main(["--mode", "comm", "--nslots", "128", "--bitsize", "8",
                              "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert rec["metric"] == "projected_interconnect_limited_efficiency"
    forms = {(r["form"], r["axis"]) for r in rec["rows"]}
    for tp in (2, 4, 8):
        for form in ("sharded_bootstrap", "sharded_bootstrap_ringtp",
                     "sharded_bootstrap_ringtp_corrected", "sharded_bootstrap_ringtp_overlap"):
            assert (form, f"tp={tp}") in forms
    assert {r["link"] for r in rec["rows"]} == {"nvlink", "network"}
    ks2 = next(r for r in rec["rows"] if r["axis"] == "tp=2" and r["form"] == "sharded_bootstrap")
    # 8192 rows of int32 keyswitch partials, (n+1)*4 = 2524 columns, half received.
    assert ks2["payload_bytes_per_device_per_launch"] == 8192 * 2524 * 4 // 2
    assert ks2["projected_efficiency"] == pytest.approx(
        rec["batch_seconds"] / (rec["batch_seconds"] + ks2["t_comm_s"]))
    for r in rec["rows"]:
        for key in ("projected_efficiency", "projected_efficiency_vs_ideal"):
            if key in r:
                assert 0 < r[key] <= 1


def test_weak_scaling_over_gloo_worlds_of_one_and_two(tmp_path):
    out = tmp_path / "boot.json"
    run = subprocess.run([sys.executable, "-m", "peba1_tpu_torch.bench_scaling", "--mode",
                          "bootstrap", "--params", "toy", "--sizes", "1,2", "--reps", "1",
                          "--per-device-batch", "16", "--device", "cpu", "--out", str(out)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == rec
    assert rec["metric"] == "weak_scaling_efficiency_bootstrap"
    assert set(rec["times_s"]) == {"1", "2"} and rec["efficiency"]["1"] == 1.0
    assert rec["verified"] == {"1": 16, "2": 32}      # every bit decrypted right
    assert rec["backend"] == "gloo" and rec["device"] == "cpu"
    assert rec["virtual_cpu_mesh"] and rec["power_limit"] is None


def test_bench_scaling_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run = subprocess.run([sys.executable, "-m", "peba1_tpu_torch.bench_scaling",
                          "--device", "cuda"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr and not run.stdout
