"""The port's command-line tools on the CPU at toy sizes: the sweep CLI's
staged interrupt, resume and finalize (the twin of
tests/test_sweep_finalize.py), the protocol benchmark's three
configurations, and every tool's refusal to run without a card when asked
for one."""

import json
import subprocess
import sys

import pytest
import torch

from peba1_tpu_torch import bench_matches, sweep_identify

torch.set_num_threads(1)


def test_sweep_interrupt_resume_then_finalize(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    base = ["--params", "toy_t2", "--n-templates", "8", "--chunk", "4",
            "--nslots", "2", "--bitsize", "3", "--dir", ckpt, "--device", "cpu"]

    # stage 1: a deliberate interrupt after one chunk
    out1 = tmp_path / "stage1.json"
    sweep_identify.main(base + ["--out", str(out1), "--max-chunks", "1"])
    rec1 = json.loads(out1.read_text())
    assert rec1["status"] == "interrupted"
    assert rec1["chunks_done"] == 1 and rec1["chunks_total"] == 2
    assert rec1["sk_device"] == "cpu" and rec1["device"] == "cpu"

    # finalize of the partial state: checks and decrypts the one chunk
    outp = tmp_path / "partial.json"
    sweep_identify.main(base + ["--out", str(outp), "--finalize"])
    recp = json.loads(outp.read_text())
    assert recp["status"].startswith("partial (1/2")
    assert recp["decisions_verified"] == 4 and recp["correct_frac"] == 1.0
    assert recp["fingerprint_match"] == "exact"          # the same generators

    # stage 2: resume to completion
    out2 = tmp_path / "stage2.json"
    sweep_identify.main(base + ["--out", str(out2)])
    rec2 = json.loads(out2.read_text())
    assert rec2["status"] == "complete"
    assert rec2["resumed_from_disk"] == 1 and rec2["computed_this_run"] == 1
    assert rec2["correct_frac"] == 1.0 and rec2["decisions_verified"] == 8

    # finalize of the complete state reproduces the compute path's numbers
    out3 = tmp_path / "final.json"
    sweep_identify.main(base + ["--out", str(out3), "--finalize",
                                "--merge-rates", str(out1)])
    rec3 = json.loads(out3.read_text())
    assert rec3["status"] == "complete" and rec3["finalize_mode"]
    assert rec3["decisions_verified"] == 8 and rec3["correct_frac"] == 1.0
    assert rec3["fingerprint_match"] == "exact"
    assert rec3["bootstraps_per_template"] == rec2["bootstraps_per_template"]
    # rates come from the per-chunk seconds kept in the chunks' metadata
    assert rec3["timed_chunks"] == 2 and rec3["templates_per_s_steady"] > 0
    assert rec3["chunk_seconds"] == {**rec1["chunk_seconds"], **rec2["chunk_seconds"]}
    assert rec3["device"] == "cpu" and rec3["power_limit"] is None


def test_sweep_refuses_a_directory_of_another_sweep(tmp_path):
    base = ["--params", "toy", "--chunk", "4", "--nslots", "1", "--bitsize", "2",
            "--dir", str(tmp_path), "--device", "cpu", "--max-chunks", "1"]
    sweep_identify.main(base + ["--n-templates", "4"])
    with pytest.raises(SystemExit, match="different sweep"):
        sweep_identify.main(base + ["--n-templates", "8"])


@pytest.mark.parametrize("config,extra", [
    ("pairs", ["--pairs", "2"]), ("identify", ["--n-templates", "4"]),
    ("argmin", ["--n-templates", "4"])])
def test_bench_matches(tmp_path, config, extra):
    out = tmp_path / "rec.json"
    rec = bench_matches.main(["--config", config, "--params", "toy", "--nslots", "2",
                              "--bitsize", "2", "--device", "cpu", "--out", str(out)] + extra)
    assert json.loads(out.read_text()) == rec
    assert rec["metric"] == f"encrypted_{config}_matches_per_s"
    assert rec["correct_frac"] == 1.0 and rec["launches"] > 0
    assert rec["value"] == pytest.approx(rec["items"] / rec["seconds"])
    assert rec["device"] == "cpu" and rec["peak_memory_bytes"] is None


def test_bench_matches_split_must_divide_the_pairs():
    with pytest.raises(SystemExit):
        bench_matches.parse_args(["--pairs", "3", "--split", "2"])


@pytest.mark.parametrize("argv", [
    ["bench"], ["diag", "campaign"], ["diag", "golden"], ["sweep_identify"],
    ["bench_matches"]], ids=lambda a: "_".join(a))
def test_the_tools_refuse_a_missing_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run = subprocess.run([sys.executable, "-m", f"peba1_tpu_torch.{argv[0]}", *argv[1:],
                          "--device", "cuda"], capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr and not run.stdout
