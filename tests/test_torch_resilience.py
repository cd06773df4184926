"""gala_tpu_torch.resilience against gala_tpu.resilience, on the CPU: the
port of tests/test_data_utils.py::test_train_with_recovery, the merge of
segment results equal to gala_tpu's on the same inputs, and the two
places where the port raises and gala_tpu would train from fresh weights
without a word."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import gala_tpu_torch
from gala_tpu.resilience import _merge as jax_merge
from gala_tpu.train import TrainResult as JaxTrainResult
from gala_tpu_torch.resilience import _merge, _progress_path, load_progress, train_with_recovery
from gala_tpu_torch.train import TrainResult

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "evaluate_torch", os.path.join(REPO, "scripts", "evaluate_torch.py"))
evaluate_torch = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(evaluate_torch)


def _model():
    return gala_tpu_torch.compile_source(evaluate_torch.make_dsl("gcn", "RecovT", hidden=12),
                                         mode="train", scale=0.05, device="cpu")


def test_train_with_recovery(tmp_path):
    """Failure-recovery orchestration: a segment that dies mid-training
    restarts from the last checkpoint; a fresh 'process' (new
    orchestrator call) skips completed epochs via the progress file."""
    cm = _model()
    ckpt = str(tmp_path / "ck")
    calls = {"n": 0, "resume": []}

    def flaky_train(**kw):
        calls["n"] += 1
        calls["resume"].append(kw["resume_from"])
        if calls["n"] == 2:
            raise RuntimeError("injected device loss")
        return cm.train(warmup=1, **kw)

    res = train_with_recovery(flaky_train, iters=24, checkpoint_path=ckpt,
                              segment=8, max_restarts=2)
    assert load_progress(ckpt) == 24
    assert calls["n"] == 4          # 3 segments + 1 injected failure
    assert calls["resume"] == [None, ckpt, ckpt, ckpt]
    assert len(res.losses) == 24
    assert res.max_accuracy > 0.7, res.max_accuracy
    # a fresh orchestrator continues instead of retraining
    with pytest.raises(RuntimeError, match="already completed"):
        train_with_recovery(flaky_train, iters=24, checkpoint_path=ckpt, segment=8)


def test_merge_equals_jax():
    rng = np.random.default_rng(0)
    fields = [dict(inference_time=float(rng.random()), total_time=float(rng.random()),
                   max_accuracy=float(rng.random()), losses=rng.random(n).tolist(),
                   accuracies=rng.random(n // 5 + 1).tolist(), params=None,
                   memory_mb=float(rng.random() * 100)) for n in (8, 8, 3, 0)]
    got = _merge([TrainResult(**f) for f in fields])
    want = jax_merge([JaxTrainResult(**f) for f in fields])
    for name in ("inference_time", "total_time", "max_accuracy", "losses", "accuracies",
                 "memory_mb"):
        assert getattr(got, name) == getattr(want, name), name


def test_progress_file_is_shared_with_jax_and_raises_where_jax_retrains(tmp_path):
    """The progress file's name is gala_tpu's; an unreadable one raises
    (gala_tpu reads 0 epochs done), and so does progress whose checkpoint
    is missing (gala_tpu would resume from nothing)."""
    from gala_tpu.resilience import _progress_path as jax_progress_path

    for path in ("ck", "ck.npz", "dir/"):
        assert _progress_path(path) == jax_progress_path(path)
    ckpt = str(tmp_path / "ck")
    assert load_progress(ckpt) == 0
    with open(_progress_path(ckpt), "w") as f:
        f.write("{not json")
    with pytest.raises(json.JSONDecodeError):
        load_progress(ckpt)
    with open(_progress_path(ckpt), "w") as f:
        json.dump({"epochs_done": 8}, f)

    def never(**kw):
        raise AssertionError("no segment may run")

    with pytest.raises(FileNotFoundError, match="missing"):
        train_with_recovery(never, iters=24, checkpoint_path=ckpt, segment=8)
