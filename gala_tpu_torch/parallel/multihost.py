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
import multiprocessing.connection
import os
import pickle
import signal
import tempfile
import time

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
        if dist.is_initialized():  # fn may have left the group itself
            dist.destroy_process_group()


# What a rank reports when a peer it was waiting on has gone: the effect of
# a failure elsewhere in the world, not its cause.
PEER_LOST = ("Connection closed by peer", "Connection reset by peer", "Broken pipe")
# Seconds the other ranks get to end on their own once one has failed,
# before spawn terminates them (their own errors are its evidence).
GRACE_S = 30.0


def spawn(fn, world: int, backend: str, *args, store: str | None = None,
          timeout: float | None = None) -> None:
    """Run fn(rank, *args) in `world` fresh processes of this host, each a
    rank of one process group over a FileStore (`store`, a file path that
    must not exist yet; a temporary one by default): the counterpart of
    one JAX process driving every local chip.  `fn` must be importable
    (the processes start from a fresh import).  timeout: seconds the
    group's operations wait (torch's default, 30 minutes, when None), for
    the world and every group a mesh creates (world_timeout): a send,
    receive or collective that no peer matches raises after it.

    When a rank fails, the others get GRACE_S seconds to end on their own
    and are then terminated; every rank's outcome is read, and the root
    cause is raised (root_cause), its message naming the other ranks'
    errors: a rank that loses its peer fails too, often first."""
    check_backend(backend, world)
    if store is None:
        with tempfile.TemporaryDirectory() as tmp:
            spawn(fn, world, backend, *args, store=os.path.join(tmp, "store"), timeout=timeout)
        return
    ctx = torch.multiprocessing.spawn(_rank_main, args=(world, backend, store, timeout, fn, args),
                                      nprocs=world, join=False)
    stopped = _join_all(ctx.processes, GRACE_S)
    errors = _rank_errors(ctx, stopped)
    if not errors:
        return
    cause = root_cause(errors, stopped)
    others = "; ".join(f"rank {r}: {_last_line(e)}" for r, e in sorted(errors.items())
                       if r != cause)
    msg = (f"rank {cause} of {world} failed, the root cause (the other ranks: "
           f"{others or 'none failed'}):\n{errors[cause]}")
    proc = ctx.processes[cause]
    if not errors[cause].startswith("rank exited"):
        raise torch.multiprocessing.ProcessRaisedException(msg, cause, proc.pid)
    raise torch.multiprocessing.ProcessExitedException(msg, cause, proc.pid, proc.exitcode)


def _join_all(procs, grace: float) -> set:
    """Wait for every process; once one has failed, the others get `grace`
    seconds to end on their own, then are terminated.  Returns the indices
    of the processes it terminated."""
    deadline, stopped = None, set()
    while True:
        alive = [p for p in procs if p.exitcode is None]
        if not alive:
            return stopped
        if deadline is None and any(p.exitcode for p in procs):
            deadline = time.monotonic() + grace
        if deadline is not None and time.monotonic() >= deadline:
            for p in alive:
                stopped.add(procs.index(p))
                p.terminate()
            for p in alive:
                p.join(10)
                if p.exitcode is None:
                    p.kill()
                p.join()
            return stopped
        wait = None if deadline is None else max(0.0, deadline - time.monotonic())
        multiprocessing.connection.wait([p.sentinel for p in alive], timeout=wait)


def _rank_errors(ctx, stopped: set) -> dict:
    """{rank: its error} of every rank that did not end cleanly: the
    traceback torch's spawn wrote for it, else how it ended."""
    errors = {}
    for rank, (proc, path) in enumerate(zip(ctx.processes, ctx.error_files)):
        if proc.exitcode == 0:
            continue
        if os.path.exists(path):
            with open(path, "rb") as fh:
                errors[rank] = pickle.load(fh)
            os.unlink(path)
        elif rank in stopped:
            errors[rank] = f"rank exited: terminated by spawn after {GRACE_S:g} s"
        elif proc.exitcode < 0:
            sig = -proc.exitcode
            name = signal.Signals(sig).name if sig in signal.valid_signals() else sig
            errors[rank] = f"rank exited: signal {name}"
        else:
            errors[rank] = f"rank exited with code {proc.exitcode}"
    return errors


def root_cause(errors: dict, stopped: set = frozenset()) -> int:
    """The rank whose failure the others followed: the first (by rank) whose
    error is its own (not a lost peer, PEER_LOST), else the first that
    ended on its own, else the first that lost its peer, else the first.
    PEER_LOST holds gloo's messages only: under NCCL a lost peer reads as
    a rank's own error, and the order falls back to rank number.  A rank
    still stuck in a collective GRACE_S after the first failure (a group
    timeout longer than GRACE_S) is terminated and ranks as stopped."""
    def order(r):
        lost = any(s in errors[r] for s in PEER_LOST)
        return (r in stopped, lost, errors[r].startswith("rank exited"), r)

    return min(errors, key=order)


def _last_line(trace: str) -> str:
    lines = [ln for ln in trace.strip().splitlines() if ln.strip()]
    return lines[-1].strip() if lines else trace
