"""The ('dp', 'tp') process mesh over torch.distributed.

Counterpart of ``peba1_tpu/parallel/mesh.py``:

  * dp  -- data parallel over the ciphertext/gate batch (independent gate
           bootstraps; the 1:N template database also shards here),
  * tp  -- tensor parallel over the keyswitch-table / external-product
           output columns, joined with collectives.

One process per rank, every process running the same program.  NCCL
allows one rank per card; a gloo world may put several ranks on one card
(`init_distributed`).  The mesh is a ``DeviceMesh`` laid out row-major,
the JAX package's ``reshape(n_dp, n_tp)`` order: rank r's tp group is the
ranks (r // tp)*tp ... +tp-1, and its dp group the ranks r mod tp + i*tp.

The JAX module's ``batch_spec`` and ``replicated`` return PartitionSpecs for
XLA's partitioner; PyTorch has none, so they have no counterpart: the
functions of ``parallel/shard.py`` slice and gather explicitly.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "tp")


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device="cuda",
                     backend: str | None = None) -> torch.device:
    """Join this process to the world and return the device it computes on.

    `backend` defaults to the device's own: NCCL for "cuda", gloo for
    "cpu".  ``backend="gloo"`` with ``device="cuda"`` makes a rank that
    computes on a card and joins its collectives through the host (gloo
    stages CUDA tensors there): the form for more ranks than cards, since
    NCCL allows one rank per card.  A request for the card without one
    raises, and so does NCCL on the CPU; nothing falls back to gloo.
    `init_method` is a ``tcp://host:port`` or ``file://path`` rendezvous;
    left None, the three arguments come from torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  On the card
    the process takes ``cuda:LOCAL_RANK`` (LOCAL_RANK from the environment,
    else the rank: one node); a gloo rank takes it modulo the cards, so
    every rank of a world larger than the cards shares one.  Pass the
    returned device to `make_mesh`.  A second call in an initialized
    process is a no-op that returns the same device.
    """
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("init_distributed: NCCL needs device='cuda'")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_distributed: no CUDA device for a {backend} rank on "
                               "the card (pass device='cpu' for gloo on the CPU)")
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        if backend == "gloo":
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank,
            device_id=device if backend == "nccl" else None)
    return device


def make_mesh(n_dp: int | None = None, n_tp: int = 1, *, device) -> DeviceMesh:
    """The ('dp', 'tp') mesh over every rank of the world (n_dp defaults to
    world / n_tp), on the rank's `device` as `init_distributed` returned
    it.  Every rank calls it, in the same order as the others."""
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_tp
    if n_dp * n_tp != world:
        raise ValueError(f"a {n_dp}x{n_tp} mesh needs {n_dp * n_tp} ranks; the "
                         f"world has {world} (one rank per process)")
    return DeviceMesh(torch.device(device).type, torch.arange(world).view(n_dp, n_tp),
                      mesh_dim_names=AXES)


def make_global_mesh(n_tp: int = 1, *, device) -> DeviceMesh:
    """The ('dp', 'tp') mesh over all nodes' ranks, after `init_distributed`
    (`device` is what it returned).

    Ranks are numbered node-major (torchrun's order), so a tp group stays on
    one node, its collectives on NVLink, as long as n_tp divides the ranks
    per node (LOCAL_WORLD_SIZE, else the world: one node); dp spans nodes.
    """
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if n_tp > 1 and per_node % n_tp != 0:
        raise ValueError(f"n_tp={n_tp} must divide the ranks per node {per_node} "
                         "so tp collectives stay on NVLink")
    return make_mesh(dist.get_world_size() // n_tp, n_tp, device=device)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along `axis` ('dp' or 'tp')."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]
