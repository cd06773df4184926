"""The port's compiled GCN and GAT training paths against gala_tpu's, end to
end on the CPU: the same DSL (__graft_entry__.GCN_DSL and GAT_DSL,
examples/gat.txt for multi-head), the same synthetic data and the JAX
weights copied over, strategy 'bell' on both sides.

Tolerances: rtol 1e-5 for one forward (f32, sums in another order);
rtol 1e-4 for losses over 6 Adam steps and 1e-3 (atol 1e-5) for the final
weights, since Adam's division by sqrt(v) amplifies last-bit
differences.  The data seed matters there: with seed 3 of this generator
one hidden pre-activation sits at 0 within rounding, its ReLU goes
different ways on the two sides and Adam carries that into one hidden
unit's weights (1e-4 apart after 6 epochs, while the losses still agree
to 2e-6); seeds 0-2 and 4-7 agree to 4e-7 beyond rtol 1e-3."""
import os

import jax
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu_torch
from __graft_entry__ import GAT_DSL, GCN_DSL
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.train import TrainResult as JaxTrainResult
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.dsl.parser import parse_file, parse_source
from gala_tpu_torch.models import gcn
from gala_tpu_torch.train import TrainResult
from gala_tpu_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(make):
    return make(n=600, avg_degree=8, n_feats=24, n_classes=5, seed=0)


def _compile_pair(source, mode="train"):
    jcm = gala_tpu.compile_source(source, mode=mode, data=_data(jax_dataset), strategy="bell")
    tcm = gala_tpu_torch.compile_source(source, mode=mode, data=_data(torch_dataset),
                                        strategy="bell", device="cpu")
    jparams = jax.device_get(jcm.make_params(0))
    return jcm, tcm, jparams


@pytest.fixture(scope="module")
def models():
    return _compile_pair(GCN_DSL)


@pytest.fixture(scope="module")
def gat_models():
    return _compile_pair(GAT_DSL)


def _by_uid(carry):
    return [np.asarray(v) for _, v in sorted(carry.items())]


def _train_rows(cm):
    return np.flatnonzero(np.asarray(cm.train_mask))


def _same_program(jcm, tcm):
    assert tcm.full_graphs[0].strategy == jcm.full_graphs[0].strategy == "bell"
    assert [n.op.name for n in tcm.program.all_nodes()] == [n.op.name for n in jcm.program.all_nodes()]
    np.testing.assert_array_equal(tcm.x.numpy(), np.asarray(jcm.x))
    np.testing.assert_array_equal(tcm.labels.numpy(), np.asarray(jcm.labels))
    assert len(tcm.train_graphs) == len(jcm.train_graphs) == 2


def test_lowering_builds_the_same_program(models):
    _same_program(*models[:2])


def test_gat_lowering_builds_the_same_program(gat_models):
    jcm, tcm, _ = gat_models
    _same_program(jcm, tcm)
    assert [n.op.name for n in tcm.program.loop.nodes].count("FUSED_ATTENTION") == 2
    for g in tcm.full_graphs[:1] + tcm.train_graphs:
        assert g.attn is not None and g.attn.fwd.n_real == g.n_nodes


def test_invariant_forward_and_forward_rows_match_jax(models):
    _forwards_match(*models)


def test_gat_invariant_forward_and_forward_rows_match_jax(gat_models):
    _forwards_match(*gat_models)


def _forwards_match(jcm, tcm, jparams):
    params = params_from_jax(jparams)
    invariant, forward = jax.jit(jcm.invariant), jax.jit(jcm.forward)
    forward_rows = jax.jit(jcm.forward_rows)
    for jgs, tgs in ((jcm.full_graphs, tcm.full_graphs), (jcm.train_graphs, tcm.train_graphs)):
        jcarry = invariant(jgs, jcm.x)
        with torch.no_grad():
            tcarry = tcm.invariant(tgs, tcm.x)
            want, got = _by_uid(jcarry), _by_uid(tcarry)
            assert len(want) == len(got)
            for w, g in zip(want, got):
                np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(
                tcm.forward(params, tgs, tcarry).numpy(),
                np.asarray(forward(jparams, jgs, jcarry)), **TOL)
            rows = _train_rows(tcm)
            np.testing.assert_allclose(
                tcm.forward_rows(params, tgs, tcarry, torch.from_numpy(rows)).numpy(),
                np.asarray(forward_rows(jparams, jgs, jcarry, rows)), **TOL)


def test_hand_gcn_matches_compiled_forward(models):
    """Passes off, as gala_tpu's own test of its hand model: the
    operator_reordering pass moves `norm *` and the aggregation across
    the FFN, which is exact only for a zero bias."""
    spec = parse_source(GCN_DSL)
    for k in vars(spec.passes):
        setattr(spec.passes, k, False)
    cm = gala_tpu_torch.compile_model(spec, mode="inference", data=_data(torch_dataset),
                                      strategy="bell")
    hand = gcn.init(torch.Generator().manual_seed(0), 24, [32], 5)
    params = torch.nn.ModuleDict({"weight1": hand["fc"][0], "weight2": hand["fc"][1]})
    with torch.no_grad():
        want = gcn.forward(hand, cm.full_graphs, cm.x).numpy()
        got = cm.forward(params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_training_matches_jax(models):
    """6 epochs, valid_step 5: epochs 0 and 5 step on the full graph,
    1-4 on the training subgraphs."""
    _training_matches(*models)


def test_gat_training_matches_jax(gat_models):
    """The GCN test's 6 epochs for GAT_DSL: the attention op's forward and
    its flash-identity backward in every step."""
    _training_matches(*gat_models)


def _training_matches(jcm, tcm, jparams):
    jres = jcm.train(iters=6, warmup=1)
    tres = tcm.train(iters=6, warmup=1, params=params_from_jax(jparams))
    assert len(tres.losses) == len(jres.losses) == 6
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=1e-6)
    final_j = jax.device_get(jres.params)
    final_t = params_to_numpy(tres.params)
    assert final_t.keys() == final_j.keys()
    for name in final_j:
        for k in ("w", "b"):
            np.testing.assert_allclose(final_t[name][k], final_j[name][k], rtol=1e-3, atol=1e-5)
    assert tres.total_time >= 0 and tres.inference_time >= 0


def test_trainresult_csv_has_the_jax_format():
    kw = dict(inference_time=0.25, total_time=0.5, max_accuracy=0.75, losses=[], accuracies=[],
              params=None, memory_mb=12.5)
    for flags in ((False, False), (True, False), (False, True)):
        assert TrainResult(**kw).csv(*flags) == JaxTrainResult(**kw).csv(*flags)


def test_weights_round_trip(models):
    _, _, jparams = models
    back = params_to_numpy(params_from_jax(jparams))
    for name in jparams:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k], np.asarray(jparams[name][k]))


def test_make_params_draws_the_nn_linear_law(models):
    _, tcm, jparams = models
    p = params_to_numpy(tcm.make_params(0))
    again = params_to_numpy(tcm.make_params(0))
    for name, layer in p.items():
        assert layer["w"].shape == np.asarray(jparams[name]["w"]).shape
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        assert np.abs(layer["w"]).max() <= bound and np.abs(layer["b"]).max() <= bound
        np.testing.assert_array_equal(layer["w"], again[name]["w"])


@pytest.mark.parametrize("what", ["bf16", "int64", "pallas_bell", "attention on dense",
                                  "sampling", "col_tile"])
def test_unported_options_raise(what):
    """Each option not yet ported raises naming its ROADMAP item.  Attention
    on 'dense' is ported: it builds no attention layout and runs the
    unfused chain, as gala_tpu does, and its forward matches gala_tpu's
    (the 6-epoch parity is in tests/test_torch_edge.py)."""
    spec = parse_source(GAT_DSL if what.startswith("attention") else GCN_DSL)
    kw = {"bf16": {"dtype": torch.bfloat16}, "int64": {"use_long": True},
          "pallas_bell": {"strategy": "pallas_bell"},
          "attention on dense": {"strategy": "dense"}}.get(what, {})
    if what == "sampling":
        spec.compute.sample_dynamic = 4
    if what == "col_tile":
        spec.col_tile = 64
    if what == "attention on dense":
        jcm = gala_tpu.compile_source(GAT_DSL, mode="train", data=_data(jax_dataset), **kw)
        tcm = gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), **kw)
        assert tcm.full_graphs[0].strategy == "dense" and tcm.full_graphs[0].attn is None
        jparams = jax.device_get(jcm.make_params(0))
        with torch.no_grad():
            got = tcm.forward(params_from_jax(jparams), tcm.full_graphs,
                              tcm.invariant(tcm.full_graphs, tcm.x))
        want = jax.jit(jcm.forward)(jparams, jcm.full_graphs,
                                    jcm.invariant(jcm.full_graphs, jcm.x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), **kw)


def test_compiled_model_run_prints_the_csv_line(models):
    _, tcm, _ = models
    parts = tcm.run(iters=7).split(",")
    assert len(parts) == 2 and float(parts[1]) >= float(parts[0]) > 0


def _gat_example(heads_guard=None):
    """examples/gat.txt (2-layer GAT, hidden 32, attention_heads(4))."""
    spec = parse_file(os.path.join(REPO, "examples", "gat.txt"))
    assert spec.attention_heads == 4
    if heads_guard == "divide":
        spec.output_sizes = [30, 5]          # 30 % 4 != 0
    if heads_guard == "unfused":
        spec.passes.attention_fusion = False
    return spec


@pytest.mark.parametrize("guard,match", [("divide", "divide"),
                                         ("unfused", "requires the fused attention path")])
def test_multihead_gat_guards(guard, match):
    """The port's counterpart of gala_tpu's multi-head guards, built from
    examples/gat.txt."""
    with pytest.raises(ValueError, match=match):
        gala_tpu_torch.compile_model(_gat_example(guard), mode="train",
                                     data=_data(torch_dataset), strategy="bell")


def test_multihead_gat_matches_jax():
    """attention_heads(4): the hidden layer attends with 4 heads, the last
    with one; the forward agrees with gala_tpu's."""
    from gala_tpu.dsl.parser import parse_file as jparse_file

    path = os.path.join(REPO, "examples", "gat.txt")
    jcm = gala_tpu.compile_model(jparse_file(path), mode="train", data=_data(jax_dataset),
                                 strategy="bell")
    tcm = gala_tpu_torch.compile_model(_gat_example(), mode="train", data=_data(torch_dataset),
                                       strategy="bell", device="cpu")
    fused = [n for n in tcm.program.all_nodes() if n.op.name == "FUSED_ATTENTION"]
    assert sorted(n.inputs[1].cols for n in fused) == [1, 4]
    jparams = jax.device_get(jcm.make_params(0))
    with torch.no_grad():
        got = tcm.forward(params_from_jax(jparams), tcm.full_graphs,
                          tcm.invariant(tcm.full_graphs, tcm.x))
    want = jax.jit(jcm.forward)(jparams, jcm.full_graphs, jcm.invariant(jcm.full_graphs, jcm.x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
