"""Minibatch GraphSAGE of gala_tpu_torch (train_minibatch.py, the shared
sampler data/minibatch.py) against gala_tpu's, on the CPU.

A 600-node synthetic graph with 16 features, fanouts (5, 3), batch 64;
gala_tpu's weights copied over, the same sampled indices on both sides
(the sampler is a verbatim copy).  Tolerances: 1e-5 for logits, the
batch loss and its gradients (f32, the means and matmuls summed in
another order); 1e-4 for per-epoch losses over 3 epochs of Adam steps
(about 10 steps an epoch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gala_tpu.train_minibatch as JM
import gala_tpu_torch.train_minibatch as TM
from gala_tpu.data.minibatch import NeighborSampler as JSampler
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.models import sage as jsage
from gala_tpu_torch.data.csr import coo_to_csr
from gala_tpu_torch.data.minibatch import NeighborSampler
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.models import sage as tsage
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.train import masked_cross_entropy
from gala_tpu_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
FANOUTS, BATCH, HIDDEN = (5, 3), 64, 16


def _data(make):
    return make(n=600, avg_degree=8, n_feats=16, n_classes=5, seed=0)


@pytest.fixture(scope="module")
def batch():
    """gala_tpu's init, the padded feature table and one sampled batch
    (targets, n1, n2, labels, mask) from each package's sampler."""
    g, feats, labels, masks = _data(torch_dataset)
    jparams = jax.device_get(jsage.init(jax.random.key(0), 16, [HIDDEN], 5))
    xt = Graph.from_host(g, device="cpu").pad_nodes(feats).numpy()
    nodes = np.flatnonzero(masks["train"])
    eb = NeighborSampler(g, FANOUTS, BATCH).epoch(nodes, 1, seed=3)
    jeb = JSampler(_data(jax_dataset)[0], FANOUTS, BATCH).epoch(nodes, 1, seed=3)
    for a, b in ((eb.targets, jeb.targets), (eb.n1, jeb.n1), (eb.n2, jeb.n2)):
        np.testing.assert_array_equal(a, b)
    y = labels[eb.targets[0]].astype(np.int64)
    return jparams, xt, (eb.targets[0], eb.n1[0], eb.n2[0], y, eb.mask[0])


def test_forward_minibatch_matches_jax(batch):
    jparams, xt, (t, n1, n2, _, _) = batch
    want = JM.forward_minibatch(jparams, jnp.asarray(xt), t, n1, n2)
    with torch.no_grad():
        got = TM.forward_minibatch(params_from_jax(jparams), torch.from_numpy(xt),
                                   *(torch.from_numpy(a) for a in (t, n1, n2)))
    assert got.shape == (BATCH, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batch_loss_and_gradients_match_jax(batch):
    """The batch loss of gala_tpu's train_sage_minibatch (masked mean NLL)
    and its gradient for every parameter."""
    jparams, xt, (t, n1, n2, y, m) = batch

    def jloss(p):
        logp = jax.nn.log_softmax(JM.forward_minibatch(p, jnp.asarray(xt), t, n1, n2))
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
        mf = jnp.asarray(m, jnp.float32)
        return jnp.sum(nll * mf) / jnp.maximum(jnp.sum(mf), 1.0)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    params = params_from_jax(jparams)
    loss = masked_cross_entropy(
        TM.forward_minibatch(params, torch.from_numpy(xt),
                             *(torch.from_numpy(a) for a in (t, n1, n2))),
        torch.from_numpy(y), torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    want = jax.device_get(jg)
    for key in ("fc", "sfc"):
        for li in range(2):
            for k in ("w", "b"):
                np.testing.assert_allclose(params[key][li][k].grad.numpy(),
                                           want[key][li][k], **TOL)


def test_training_matches_jax(monkeypatch):
    """3 epochs of train_sage_minibatch (dynamic sampling, valid_step 1)
    from gala_tpu's initial weights, which the port's sage.init is made to
    return: per-epoch losses within 1e-4, the same max accuracy."""
    kw = dict(fanouts=FANOUTS, batch_size=BATCH, hidden=HIDDEN, iters=3, valid_step=1,
              warmup=1, seed=0)
    jres = JM.train_sage_minibatch(*_data(jax_dataset), **kw)
    jparams = jax.device_get(jsage.init(jax.random.key(0), 16, [HIDDEN], 5))
    monkeypatch.setattr(tsage, "init", lambda *a, **k: params_from_jax(jparams))
    tres = TM.train_sage_minibatch(*_data(torch_dataset), device="cpu", **kw)
    assert len(tres.losses) == len(jres.losses) == 3
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    assert len(tres.accuracies) == len(jres.accuracies) == 4
    assert tres.max_accuracy == pytest.approx(jres.max_accuracy, abs=1e-6)
    assert tres.losses[-1] < tres.losses[0]
    assert tres.total_time > 0 and tres.total_time == tres.inference_time
    final = params_to_numpy(tres.params)
    want = jax.device_get(jres.params)
    np.testing.assert_allclose(final["fc"][0]["w"], want["fc"][0]["w"], rtol=1e-3, atol=1e-5)


def test_minibatch_estimator_exact_on_regular_graph():
    """gala_tpu's deterministic check, on the port: on a circulant
    4-regular graph with fanout == degree and the (ra, rb) = (1, 0)
    enumeration, the sampled mean is the exact neighbor mean, so the
    minibatch logits equal the full-graph SAGE logits."""
    rng = np.random.default_rng(0)
    n, d = 64, 4
    src = np.concatenate([(np.arange(n) + o) % n for o in (1, 2, 3, 4)])
    dst = np.tile(np.arange(n), 4)
    g = coo_to_csr(src=src.astype(np.int64), dst=dst.astype(np.int64), vals=None,
                   n_rows=n, n_cols=n)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    params = tsage.init(torch.Generator().manual_seed(0), 8, [16], 3)
    gd = Graph.from_host(g, device="cpu")
    xt = gd.pad_nodes(feats)
    eb = NeighborSampler(g, fanouts=(d, d), batch_size=n).epoch(np.arange(n), epoch=0, seed=0,
                                                               dynamic=False)
    with torch.no_grad():
        full = tsage.forward(params, [gd, gd], xt)[:n].numpy()
        out = TM.forward_minibatch(params, xt, *(torch.from_numpy(a[0]) for a in
                                                 (eb.targets, eb.n1, eb.n2))).numpy()
    np.testing.assert_allclose(out, full[eb.targets[0]], rtol=1e-4, atol=1e-5)


def test_unported_dtype_raises():
    """bf16 is ported (one epoch runs from a bf16 feature table, params f32;
    its parity with gala_tpu is in tests/test_torch_bf16.py); a dtype that
    neither package's kernels take, float16, is refused."""
    res = TM.train_sage_minibatch(*_data(torch_dataset), dtype=torch.bfloat16, device="cpu",
                                  fanouts=FANOUTS, batch_size=BATCH, hidden=HIDDEN, iters=1)
    assert len(res.losses) == 1 and np.isfinite(res.losses[0])
    assert all(p.dtype == torch.float32 for p in res.params.parameters())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TM.train_sage_minibatch(*_data(torch_dataset), dtype=torch.float16, device="cpu")
