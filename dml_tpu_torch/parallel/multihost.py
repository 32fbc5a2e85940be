"""Multi-host start-up: torch.distributed wired to the cluster spec.
PyTorch counterpart of dml_tpu/parallel/multihost.py.

One process per rank (one GPU each), every rank given the same host
arguments. This module is the compute plane's bootstrap:

- `initialize_from_spec(spec, me)`: the coordinator address and this
  process's rank from the shared `config.ClusterSpec` (the first node
  coordinates, a node's index in the table is its rank), then
  `torch.distributed.init_process_group` over TCP;
- `global_mesh(mesh_spec)`: the mesh over every rank of the world;
- `global_batch(local_data, mesh)`: this rank's rows on its device with
  the global batch's shape (`GlobalBatch`), which `Trainer.step` takes
  as they are, so every rank's input pipeline (`data.Prefetcher` on its
  own files) feeds its own shard and no rank builds the global batch.

A single process needs no distributed runtime: `initialize` is a no-op
for it, and every form runs its one-device code on a one-rank mesh.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ClusterSpec, MeshSpec, NodeId
from ..models.lm_params import resolve_device
from .mesh import Mesh, make_mesh

log = logging.getLogger(__name__)

#: the rendezvous listens on its own port, offset from the node's
#: control-plane UDP port (as the JAX package's coordinator does)
COORD_PORT_OFFSET = 20_000

_initialized = False


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device=None) -> None:
    """Idempotent `torch.distributed.init_process_group` over
    `tcp://coordinator_address`; a no-op for a single process. The
    backend is NCCL when the rank's device is CUDA (`device`, default
    `cuda:<process_id % device count>`, made current) and gloo when it is
    the CPU."""
    global _initialized
    if _initialized or num_processes <= 1:
        return
    dev = resolve_device(device)
    if device is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _initialized = True
    log.info("torch.distributed up: rank %d of %d (%s)", process_id, num_processes,
             dist.get_backend())


def initialize_from_spec(spec: ClusterSpec, me: NodeId, device=None) -> int:
    """Start the runtime from the cluster spec: coordinator = the spec's
    first node at its port + COORD_PORT_OFFSET, rank = this node's index
    in the node table. Returns the rank; ValueError for a node not in
    the spec."""
    nodes = list(spec.nodes)
    try:
        process_id = next(i for i, n in enumerate(nodes) if n.unique_name == me.unique_name)
    except StopIteration:
        raise ValueError(f"{me.unique_name} not in cluster spec") from None
    head = nodes[0]
    initialize(f"{head.host}:{head.port + COORD_PORT_OFFSET}", num_processes=len(nodes),
               process_id=process_id, device=device)
    return process_id


def global_mesh(mesh_spec: Optional[MeshSpec] = None) -> Mesh:
    """The mesh over every rank of the world (every rank calls it)."""
    return make_mesh(mesh_spec)


class GlobalBatch(NamedTuple):
    """This rank's rows of a batch sharded over dp, and the global
    batch's shape."""

    local: torch.Tensor
    shape: Tuple[int, ...]


def global_batch(local_data, mesh: Mesh, device=None) -> GlobalBatch:
    """A rank's own rows (numpy or tensor) as a dp shard of a global
    batch: on `device` (cuda unless given), with the global shape (rows
    times the dp axis). The ranks of one tp group give the same rows."""
    t = local_data if isinstance(local_data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(local_data))
    dp = mesh.shape["dp"]
    return GlobalBatch(t.to(resolve_device(device)), (t.shape[0] * dp, *t.shape[1:]))
