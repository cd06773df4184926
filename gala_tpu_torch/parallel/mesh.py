"""Process meshes (the port of gala_tpu.parallel.mesh).

gala_tpu lays its devices out as a `jax.sharding.Mesh` with axes

    'data'  -- node partitions: graph rows, features and the edges into
               them (data and edge parallelism);
    'model' -- feature columns of the FFN weights (tensor parallelism).

Here each device is a process ("rank", torch.distributed), and the mesh
is that rank's place in the same (data, model) grid: rank = d * M + m.
Its collectives run over one process group per axis: `data_group`
holds the ranks of its model column (the node partitions it exchanges
halo rows and gradients with), `model_group` the ranks of its data row
(the shards of its weights).  A rank's device comes with it: its own
card under NCCL; under gloo the card it shares with other ranks, or the
CPU.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from gala_tpu_torch.parallel.multihost import check_backend, initialize, world_timeout


@dataclasses.dataclass
class Mesh:
    """One rank's view of a (data, model) process mesh."""

    shape: dict                  # {"data": D, "model": M}
    coords: tuple                # this rank's (d, m)
    rank: int                    # its global rank, d * M + m
    data_group: object           # ProcessGroup: ranks (., m), the node-partition axis
    model_group: object          # ProcessGroup: ranks (d, .), the weight-column axis
    device: torch.device
    backend: str


def make_mesh(n: int | None = None, model_axis: int = 1, backend: str | None = None,
              device=None) -> Mesh | None:
    """The (n // M, M) mesh over ranks [0, n) of the process group (all of
    them by default), M = model_axis where it divides n, else 1 (gala_tpu's
    rule).  Joins the process group first where there is none
    (multihost.initialize, `backend`); a `backend` other than the group's
    raises.  Every rank of the group must call it (each creates every
    axis group); ranks outside the mesh get None.

    device: the rank's device; by default its own card under NCCL (raises
    past the host's device count) and cuda:(local rank mod device count)
    under gloo; "cpu" asks for the CPU."""
    initialize(backend=backend)
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have!r}, the mesh asks for {backend!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n or world
    if n > world:
        raise ValueError(f"requested {n} ranks, have {world}")
    model = model_axis if n % model_axis == 0 else 1
    data = n // model
    limit = world_timeout()
    data_groups = [dist.new_group([d * model + m for d in range(data)], timeout=limit)
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)], timeout=limit)
                    for d in range(data)]
    if rank >= n:
        return None
    d, m = divmod(rank, model)
    return Mesh(shape={"data": data, "model": model}, coords=(d, m), rank=rank,
                data_group=data_groups[m], model_group=model_groups[d],
                device=_device(have, device, rank), backend=have)


def _device(backend: str, device, rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        check_backend(backend, local + 1)
        if device is not None and torch.device(device) != torch.device("cuda", local):
            raise ValueError(f"nccl rank {rank} runs on cuda:{local}, not {device}")
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return device


def node_rows(mesh: Mesh, rows_per_shard: int) -> range:
    """The global node rows this rank owns (gala_tpu's node_sharding:
    rows split over 'data')."""
    d = mesh.coords[0]
    return range(d * rows_per_shard, (d + 1) * rows_per_shard)


def replicated(mesh: Mesh) -> range:
    """The ranks that hold a replicated array: every rank of the mesh."""
    return range(mesh.shape["data"] * mesh.shape["model"])
