"""The ('dp', 'tp') process mesh over torch.distributed.

Counterpart of ``peba1_tpu/parallel/mesh.py``:

  * dp  -- data parallel over the ciphertext/gate batch (independent gate
           bootstraps; the 1:N template database also shards here),
  * tp  -- tensor parallel over the keyswitch-table / external-product
           output columns, joined with collectives.

One process per device (NCCL allows one rank per card), every process
running the same program.  The mesh is a ``DeviceMesh`` laid out row-major,
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
                     rank: int | None = None, device="cuda") -> torch.device:
    """Join this process to the world and return its device.

    The backend follows the device: NCCL for "cuda", gloo for "cpu"; a
    request for the card without one raises, it never falls back to gloo.
    `init_method` is a ``tcp://host:port`` or ``file://path`` rendezvous;
    left None, the three arguments come from torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  On the card
    the process takes ``cuda:LOCAL_RANK`` (LOCAL_RANK from the environment,
    else the rank: one node).  A second call in an initialized process is a
    no-op that returns the same device.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for the NCCL "
                               "backend (pass device='cpu' for gloo)")
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank,
            device_id=device if device.type == "cuda" else None)
    return device


def make_mesh(n_dp: int | None = None, n_tp: int = 1) -> DeviceMesh:
    """The ('dp', 'tp') mesh over every rank of the world (n_dp defaults to
    world / n_tp).  Every rank calls it, in the same order as the others."""
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_tp
    if n_dp * n_tp != world:
        raise ValueError(f"a {n_dp}x{n_tp} mesh needs {n_dp * n_tp} ranks; the "
                         f"world has {world} (one rank per device)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).view(n_dp, n_tp),
                      mesh_dim_names=AXES)


def make_global_mesh(n_tp: int = 1) -> DeviceMesh:
    """The ('dp', 'tp') mesh over all nodes' ranks, after `init_distributed`.

    Ranks are numbered node-major (torchrun's order), so a tp group stays on
    one node, its collectives on NVLink, as long as n_tp divides the ranks
    per node (LOCAL_WORLD_SIZE, else the world: one node); dp spans nodes.
    """
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if n_tp > 1 and per_node % n_tp != 0:
        raise ValueError(f"n_tp={n_tp} must divide the ranks per node {per_node} "
                         "so tp collectives stay on NVLink")
    return make_mesh(dist.get_world_size() // n_tp, n_tp)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along `axis` ('dp' or 'tp')."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]
