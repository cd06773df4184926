"""Process-group initialization (the port of gala_tpu.parallel.multihost).

gala_tpu runs one process per host that drives every local chip; the
port runs one process per shard ("rank"), joined by a
`torch.distributed` process group.  The backend is the caller's choice
and nothing switches it: "nccl" (the default) needs one CUDA device per
rank; "gloo" takes CPU tensors, and CUDA tensors of ranks that share a
card (NCCL refuses two ranks on one device).

    # under torchrun (env://: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
    from gala_tpu_torch.parallel.multihost import initialize
    initialize()                         # backend "nccl"

    # explicit coordinator form
    initialize(coordinator_address="10.0.0.1:29500", num_processes=4,
               process_id=rank, backend="gloo")

    # one host: `world` fresh processes, fn(rank, *args) in each
    from gala_tpu_torch.parallel.multihost import spawn
    spawn(fn, 2, "gloo", *args)
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, ranks_on_host: int = 1) -> None:
    """Raise unless `backend` can run `ranks_on_host` ranks on this host:
    NCCL needs CUDA and a device of its own for every rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend != "nccl":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA, and torch.cuda.is_available() is false; "
                           "name backend='gloo' for CPU ranks")
    if ranks_on_host > torch.cuda.device_count():
        raise RuntimeError(f"nccl takes one rank per device: {ranks_on_host} ranks, "
                           f"{torch.cuda.device_count()} device(s); name backend='gloo' for ranks "
                           "that share a card")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> int:
    """Join the process group (idempotent); returns the world size.

    With no coordinator, torchrun's environment (env://) where it is set,
    else a standalone world of one process (an in-process store), as
    gala_tpu leaves a process without a cluster standalone.  With one,
    the explicit tcp:// form."""
    if dist.is_initialized():
        return dist.get_world_size()
    backend = backend or "nccl"
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def is_primary() -> bool:
    """True on the rank that should write checkpoints and CSVs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_timeout() -> datetime.timedelta:
    """The default group's timeout (init_process_group's `timeout`), for
    the groups a mesh creates: dist.new_group takes torch's default
    otherwise, not the world's."""
    pg = dist.distributed_c10d._get_default_group()
    device = torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")
    return pg._get_backend(device).options._timeout


def _rank_main(rank: int, world: int, backend: str, store: str, timeout, fn, args) -> None:
    limit = None if timeout is None else datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=limit)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args, store: str | None = None,
          timeout: float | None = None) -> None:
    """Run fn(rank, *args) in `world` fresh processes of this host, each a
    rank of one process group over a FileStore (`store`, a file path that
    must not exist yet; a temporary one by default): the counterpart of
    one JAX process driving every local chip.  `fn` must be importable
    (the processes start from a fresh import).  An exception in a rank
    stops the others and is raised here.  timeout: seconds the group's
    operations wait (torch's default, 30 minutes, when None), for the world
    and every group a mesh creates (world_timeout): a send, receive or
    collective that no peer matches raises after it."""
    check_backend(backend, world)
    if store is not None:
        torch.multiprocessing.spawn(_rank_main, args=(world, backend, store, timeout, fn, args),
                                    nprocs=world, join=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        spawn(fn, world, backend, *args, store=os.path.join(tmp, "store"), timeout=timeout)
