"""gala_tpu_torch.checkpoint and train(checkpoint_path=, resume_from=)
against gala_tpu's, on the CPU.

A run of 5 epochs that saves, then 5 that resume, from the same initial
weights in both packages (weights.params_from_jax): both segments' losses
at rtol 1e-4 and the final params at rtol 1e-3 / atol 1e-5, the
tolerances of tests/test_torch_train.py (f32 sums in another order;
Adam's division by sqrt(v) amplifies last-bit differences), with, for
GIN, an atol on the losses of 1e-7 times the largest: its unnormalized
sums start the loss at 27 and bring it to 3e-3 within 10 steps, and a
loss near 0 carries the rounding of the large ones before it (as
tests/test_torch_models.py scales GIN's forward atol).  Each call
counts its epochs from 0, as in gala_tpu: the validation schedule and a
dynamically sampled program's (ra, rb) start again in the resumed call.
"""
import os

import jax
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu.data.sampling as jsampling
import gala_tpu_torch
import gala_tpu_torch.lowering.lower as tlower
from __graft_entry__ import GCN_DSL
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = open(os.path.join(REPO, "examples", "gin.txt")).read()
DYNAMIC = GCN_DSL + "aggrFn=aggrFn.sample(4).dynamic();\n"


def _data(make):
    return make(n=600, avg_degree=8, n_feats=24, n_classes=5, seed=0)


def _torch_model(source=GCN_DSL, **kw):
    return gala_tpu_torch.compile_source(source, mode="train", data=_data(torch_dataset),
                                         strategy="bell", device="cpu", **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("source", ["gin", "gcn-bf16"])
def test_round_trip_keeps_params_epsilons_adam_state_and_step(source, tmp_path):
    """What train(checkpoint_path=) wrote reads back equal: every param
    (GIN's bare epsilons among them; f32 in a bf16 program), Adam's
    moments and per-parameter step, and step = the call's epochs."""
    cm = (_torch_model(GIN) if source == "gin"
          else _torch_model(dtype=torch.bfloat16))
    path = str(tmp_path / "ck.pt")
    res = cm.train(iters=3, warmup=1, checkpoint_path=path)
    state = load_checkpoint(path)
    assert state["step"] == 3
    want = dict(res.params.named_parameters())
    assert state["param_names"] == list(want)
    for name, p in want.items():
        assert state["params"][name].dtype == torch.float32
        assert torch.equal(state["params"][name], p.detach())
    if source == "gin":
        assert {"eps1", "eps2"} <= set(want) and state["params"]["eps1"].dim() == 0
    adam = state["opt_state"]["state"]
    assert sorted(adam) == list(range(len(want)))
    for i, p in enumerate(want.values()):
        assert float(adam[i]["step"]) == 3.0
        assert adam[i]["exp_avg"].shape == p.shape and adam[i]["exp_avg_sq"].shape == p.shape
    fresh = cm.make_params(1)
    back = load_checkpoint(path, like={"params": fresh})
    assert back["params"] is fresh
    for name, p in fresh.named_parameters():
        assert torch.equal(p.detach(), want[name].detach())


def _compile_pair(source):
    jcm = gala_tpu.compile_source(source, mode="train", data=_data(jax_dataset), strategy="bell")
    return jcm, _torch_model(source), jax.device_get(jcm.make_params(0))


@pytest.mark.parametrize("source", ["gcn", "gin"])
def test_resumed_run_matches_jax(source, tmp_path):
    """5 epochs with checkpoint_path, then 5 with resume_from, in each
    package from gala_tpu's initial weights: the same losses in both
    segments and the same final params (GIN's epsilons too).  Adam's
    bias corrections continue from step 5 on both sides."""
    jcm, tcm, jparams = _compile_pair(GCN_DSL if source == "gcn" else GIN)
    jck, tck = str(tmp_path / "jax_ck"), str(tmp_path / "torch_ck")
    j1 = jcm.train(iters=5, warmup=1, checkpoint_path=jck)
    j2 = jcm.train(iters=5, warmup=1, resume_from=jck + ".npz" if os.path.exists(
        jck + ".npz") else jck)
    t1 = tcm.train(iters=5, warmup=1, params=params_from_jax(jparams), checkpoint_path=tck)
    t2 = tcm.train(iters=5, warmup=1, resume_from=tck)
    atol = 1e-7 * max(j1.losses) if source == "gin" else 0.0
    for t, j in ((t1, j1), (t2, j2)):
        assert len(t.losses) == len(j.losses) == 5
        np.testing.assert_allclose(t.losses, j.losses, rtol=1e-4, atol=atol)
    # the resumed call continued from the first one's weights
    assert t2.losses[0] < t1.losses[0]
    final_j, final_t = _flat(jax.device_get(j2.params)), _flat(params_to_numpy(t2.params))
    assert final_t.keys() == final_j.keys()
    for name in final_j:
        np.testing.assert_allclose(final_t[name], final_j[name], rtol=1e-3, atol=1e-5)


def test_dynamic_sampling_resume_feeds_epochs_from_0_as_jax(tmp_path, monkeypatch):
    """A dynamically sampled program resumed after 3 epochs: each call
    draws (ra, rb) for epochs 0, 1, 2 of its own count, as gala_tpu
    does, and the resumed losses match gala_tpu's resumed run."""
    seen = {"jax": [], "torch": []}

    def spy(side, real):
        def params(epoch, seed):
            seen[side].append(epoch)
            return real(epoch, seed)
        return params

    monkeypatch.setattr(jsampling, "dynamic_sample_params",
                        spy("jax", jsampling.dynamic_sample_params))
    monkeypatch.setattr(tlower, "dynamic_sample_params",
                        spy("torch", tlower.dynamic_sample_params))
    jcm, tcm, jparams = _compile_pair(DYNAMIC)
    jck, tck = str(tmp_path / "jax_ck"), str(tmp_path / "torch_ck")
    jcm.train(iters=3, warmup=1, checkpoint_path=jck)
    j2 = jcm.train(iters=3, warmup=1, resume_from=jck + ".npz" if os.path.exists(
        jck + ".npz") else jck)
    tcm.train(iters=3, warmup=1, params=params_from_jax(jparams), checkpoint_path=tck)
    t2 = tcm.train(iters=3, warmup=1, resume_from=tck)
    assert seen["torch"] == seen["jax"] == [0, 1, 2, 0, 1, 2]
    np.testing.assert_allclose(t2.losses, j2.losses, rtol=1e-4)


def test_resume_raises_on_a_missing_or_mismatched_checkpoint(tmp_path):
    """No quiet fall back to fresh weights: a missing file, a checkpoint
    of other parameters and one without optimizer state each raise."""
    cm = _torch_model()
    with pytest.raises(FileNotFoundError):
        cm.train(iters=2, warmup=1, resume_from=str(tmp_path / "absent.pt"))
    gin_ck = str(tmp_path / "gin.pt")
    _torch_model(GIN).train(iters=2, warmup=1, checkpoint_path=gin_ck)
    with pytest.raises(ValueError, match="holds parameters"):
        cm.train(iters=2, warmup=1, resume_from=gin_ck)
    bare = save_checkpoint(str(tmp_path / "bare.pt"), cm.make_params(0), step=0)
    assert bare == str(tmp_path / "bare.pt")
    with pytest.raises(ValueError, match="no optimizer state"):
        cm.train(iters=2, warmup=1, resume_from=bare)
