"""The multi-rank dry run (``python -m peba1_tpu_torch.dryrun``) on the CPU.

A gloo world of two CPU ranks at TOY through the command line, with the
checks of ``__graft_entry__.dryrun_multichip``; the mesh rule; the backend
choice, which never takes gloo on the card by itself (no process is spawned
there); and ``init_distributed``'s refusals.  Imports no jax.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from peba1_tpu_torch import dryrun
from peba1_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CHECKS = ["sharded_bootstrap", "ringtp_k1", "ringtp_k2", "gspmd_identify",
          "gspmd_identify_argmin"]


def test_world_of_two_cpu_ranks_passes_every_check():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "peba1_tpu_torch.dryrun", "--world", "2",
                           "--device", "cpu"], capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (rec["world"], rec["mesh"], rec["backend"], rec["device"]) == (2, [1, 2], "gloo",
                                                                            "cpu")
    assert rec["params"] == "toy" and rec["checks"] == CHECKS
    # Templates 1 and 3 drawn from default_rng(5), the probe template 1.
    assert (rec["distances"], rec["argmin"], rec["min"]) == ([0, 0], 0, 0)
    assert rec["launches"] == [dict.fromkeys(CHECKS, {})] * 2


@pytest.mark.parametrize("world,shape", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (2, 2))])
def test_mesh_rule(world, shape):
    assert dryrun.mesh_shape(world) == shape


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("device,world,cards,share,want", [
    ("cpu", 4, 0, False, "gloo"), ("cuda", 1, 1, False, "nccl"), ("cuda", 4, 4, False, "nccl"),
    ("cuda", 4, 1, True, "gloo"), ("cuda", 2, 2, True, "gloo")])
def test_backend_choice(monkeypatch, device, world, cards, share, want):
    _cards(monkeypatch, cards)
    assert dryrun.choose_backend(device, world, share) == want


def test_more_ranks_than_cards_without_share_card_raises(monkeypatch):
    """No fallback to gloo: the flag is named, and no rank is spawned."""
    _cards(monkeypatch, 1)
    monkeypatch.setattr(torch.multiprocessing, "start_processes", None)
    with pytest.raises(SystemExit, match="pass --share-card"):
        dryrun.main(["--world", "2"])


def test_cuda_without_a_card_raises(monkeypatch):
    _cards(monkeypatch, 0)
    with pytest.raises(SystemExit, match="no CUDA device"):
        dryrun.main(["--world", "2", "--share-card"])


def test_share_card_needs_the_card():
    with pytest.raises(SystemExit):
        dryrun.parse_args(["--world", "2", "--share-card", "--device", "cpu"])


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_init_distributed_on_cuda_without_a_card_raises(monkeypatch, backend):
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed("tcp://127.0.0.1:1", 1, 0, device="cuda", backend=backend)
    assert not torch.distributed.is_initialized()


def test_init_distributed_nccl_on_the_cpu_raises():
    with pytest.raises(ValueError, match="NCCL needs device='cuda'"):
        pmesh.init_distributed("tcp://127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()
