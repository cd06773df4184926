"""Failure recovery: restart-from-checkpoint training orchestration (the
port of gala_tpu.resilience).

Training runs as a sequence of RESUMABLE SEGMENTS:

- each segment is a normal `train()` call that ends with a checkpoint
  (params + optimizer state, gala_tpu_torch.checkpoint);
- a JSON progress file next to the checkpoint records completed epochs,
  so a FRESH PROCESS continues where the dead one stopped;
- an exception inside a segment (device loss, out of memory, a CUDA
  error) triggers restart from the last checkpoint, up to `max_restarts`.

Segmenting lives outside `train()`: a segment boundary is where its
timed regions end, so a save never lands inside them.  Each segment is
its own `train()` call, whose epochs (validation schedule, per-epoch
sampling inputs) count from 0, as in gala_tpu.

The progress file's name is gala_tpu's (`<checkpoint>.progress.json`,
`.npz` stripped), so one path convention serves both packages.  Two
places differ from gala_tpu, where its fallback would train from fresh
weights without a word: a progress file that cannot be read raises
(gala_tpu reads it as 0 epochs done), and so does a progress file whose
checkpoint is missing (gala_tpu starts the next segment from fresh
weights).
"""
from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

from gala_tpu_torch.train import TrainResult


def _progress_path(checkpoint_path: str) -> str:
    base = checkpoint_path.rstrip("/")
    return base.removesuffix(".npz") + ".progress.json"


def load_progress(checkpoint_path: str) -> int:
    """Epochs completed by earlier segments: 0 when there is no progress
    file; a file that cannot be read raises."""
    try:
        with open(_progress_path(checkpoint_path)) as f:
            return int(json.load(f)["epochs_done"])
    except FileNotFoundError:
        return 0


def _save_progress(checkpoint_path: str, epochs_done: int) -> None:
    with open(_progress_path(checkpoint_path), "w") as f:
        json.dump({"epochs_done": epochs_done}, f)


def _ckpt_exists(path: str) -> bool:
    return os.path.exists(path) or os.path.exists(path + ".npz")


def _resume_arg(path: str) -> str:
    return path if os.path.exists(path) else path + ".npz"


def train_with_recovery(
    train_fn: Callable[..., TrainResult],
    iters: int,
    checkpoint_path: str,
    segment: int = 20,
    max_restarts: int = 3,
    on_failure: Callable[[Exception, int], None] | None = None,
    **kw,
) -> TrainResult:
    """Run `train_fn` (train() or CompiledModel.train, any kwargs) for
    `iters` epochs total in checkpointed segments; resume across
    failures AND across process restarts.

    on_failure(exc, restart_no): optional hook (logging, device reset).
    Returns the merged TrainResult over all completed segments of THIS
    process (earlier processes' segments are reflected in the resumed
    parameters, not in the returned losses list).
    """
    done = load_progress(checkpoint_path)
    if done and not _ckpt_exists(checkpoint_path):
        raise FileNotFoundError(
            f"{_progress_path(checkpoint_path)} records {done} epochs done but the "
            f"checkpoint {checkpoint_path!r} is missing"
        )
    restarts = 0
    results: list[TrainResult] = []
    while done < iters:
        n = min(segment, iters - done)
        resume = (
            _resume_arg(checkpoint_path)
            if (done or restarts) and _ckpt_exists(checkpoint_path)
            else None
        )
        try:
            res = train_fn(
                iters=n,
                checkpoint_path=checkpoint_path,
                resume_from=resume,
                **kw,
            )
        except Exception as exc:  # noqa: BLE001 — recovery surface
            restarts += 1
            if on_failure is not None:
                on_failure(exc, restarts)
            if restarts > max_restarts:
                raise
            continue
        done += n
        _save_progress(checkpoint_path, done)
        results.append(res)
    if not results:
        raise RuntimeError(
            f"nothing to run: {done} epochs already completed (>= {iters}); "
            f"remove {_progress_path(checkpoint_path)} to retrain"
        )
    return _merge(results)


def _merge(rs: list[TrainResult]) -> TrainResult:
    losses = [l for r in rs for l in r.losses]
    accs = [a for r in rs for a in r.accuracies]
    n = sum(max(len(r.losses), 1) for r in rs)
    wt = [max(len(r.losses), 1) / n for r in rs]
    return TrainResult(
        inference_time=float(np.sum([r.inference_time * w for r, w in zip(rs, wt)])),
        total_time=float(np.sum([r.total_time * w for r, w in zip(rs, wt)])),
        max_accuracy=max((r.max_accuracy for r in rs), default=0.0),
        losses=losses,
        accuracies=accs,
        params=rs[-1].params,
        memory_mb=max((r.memory_mb for r in rs), default=0.0),
    )
