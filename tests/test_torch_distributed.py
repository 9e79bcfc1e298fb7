"""Two processes through the port's distributed entry path (the counterpart
of tests/test_distributed.py).

`parallel.mesh.init_distributed` and `make_global_mesh` are driven the way
a torchrun launch drives them: two OS processes, torchrun's environment
(``env://``), a gloo rendezvous, a process-spanning ('dp', 'tp') mesh and
cross-process collectives (all_reduce and all_gather) over its groups.
This file, run as a script, is one process.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from peba1_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


def _proc_main() -> None:
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    device = pmesh.init_distributed(device="cpu")          # env://, gloo
    assert pmesh.init_distributed(device="cpu") == device  # a no-op the second time
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"

    m = pmesh.make_global_mesh(n_tp=1, device=device)
    assert pmesh.axis_size(m, "dp") == 2 and m.get_local_rank("dp") == rank
    x = torch.tensor([rank + 1], dtype=torch.int32)
    s = x.clone()
    dist.all_reduce(s, group=m.get_group("dp"))     # cross-process reduction
    assert int(s) == 3, s
    got = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(got, x, group=m.get_group("dp"))
    assert [int(g) for g in got] == [1, 2], got

    m2 = pmesh.make_global_mesh(n_tp=2, device=device)                     # both ranks on one node
    assert (pmesh.axis_size(m2, "dp"), pmesh.axis_size(m2, "tp")) == (1, 2)
    got = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(got, x * 10, group=m2.get_group("tp"))
    assert [int(g) for g in got] == [10, 20], got
    try:
        pmesh.make_global_mesh(n_tp=4, device=device)
        raise AssertionError("n_tp=4 over 2 ranks a node did not raise")
    except ValueError as e:
        assert "must divide the ranks per node 2" in str(e), e
    dist.destroy_process_group()
    print(f"proc {rank} OK", flush=True)


def test_two_process_mesh_collectives():
    with socket.socket() as s:  # a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {rank} failed:\n{out}"
        assert f"proc {rank} OK" in out, out


def test_init_distributed_on_cuda_without_a_card_raises(monkeypatch):
    """A request for NCCL without a card fails; it never drops to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed("tcp://127.0.0.1:1", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    _proc_main()
