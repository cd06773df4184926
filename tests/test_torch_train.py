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
import math
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


def _close(got, want, atol_scale=0.0):
    """TOL, with atol raised to atol_scale * max|want| where given (a sum
    whose terms are large rounds to more than TOL's atol)."""
    want = np.asarray(want)
    atol = max(TOL["atol"], atol_scale * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol)


def _forwards_match(jcm, tcm, jparams, atol_scale=0.0):
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
                _close(g, w, atol_scale)
            _close(tcm.forward(params, tgs, tcarry).numpy(),
                   forward(jparams, jgs, jcarry), atol_scale)
            rows = _train_rows(tcm)
            _close(tcm.forward_rows(params, tgs, tcarry, torch.from_numpy(rows)).numpy(),
                   forward_rows(jparams, jgs, jcarry, rows), atol_scale)


def test_hand_gcn_matches_compiled_forward(models):
    """Passes off, as gala_tpu's own test of its hand model: the
    operator_reordering pass moves `norm *` and the aggregation across
    the FFN, which is exact only for a zero bias."""
    spec = parse_source(GCN_DSL)
    for k in vars(spec.passes):
        setattr(spec.passes, k, False)
    cm = gala_tpu_torch.compile_model(spec, mode="inference", data=_data(torch_dataset),
                                      strategy="bell", device="cpu")
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


def test_memory_field_reads_live_memory_at_the_warm_up_boundary(models, monkeypatch):
    """memMB is gala_tpu's quantity: the live allocation (torch.cuda.
    memory_allocated, gala_tpu's bytes_in_use), not the process's peak,
    read once, when the warm-up epochs are done."""
    import sys

    from gala_tpu_torch import train as T

    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 123_000_000)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 999_000_000)
    assert T.device_memory_mb(torch.device("cuda", 0)) == 123.0
    assert T.device_memory_mb("cpu") == 0.0

    calls, live = [], T.device_memory_mb

    def at_boundary(device):
        calls.append(len(sys._getframe(1).f_locals["losses"]))  # epochs run so far
        return live(device)

    monkeypatch.setattr(T, "device_memory_mb", at_boundary)
    _, tcm, _ = models
    monkeypatch.setattr(tcm.spec, "print_memory", True)
    res = tcm.train(iters=4, warmup=2)
    assert calls == [2] and res.memory_mb == 0.0  # CPU graphs: no device memory
    assert res.csv(print_memory=True).startswith("0.0,")


def test_toolchain_probe_fails_here_with_a_warning(monkeypatch):
    """Without nvcc and a card the probe answers False and warns with the
    reason, and does not raise; it is asked once per process.  No module
    of the port but ops/kernels/_build.py refers to it: no executor is
    chosen by it."""
    import shutil

    from gala_tpu_torch.ops.kernels import _build

    if torch.cuda.is_available() or shutil.which("nvcc"):
        pytest.skip("a CUDA toolchain is present: the card test holds the probe")
    monkeypatch.setattr(_build, "_toolchain_ok", None)
    with pytest.warns(UserWarning, match="toolchain probe failed: .*nvcc"):
        assert _build.toolchain_available(timeout=120) is False
    assert _build.toolchain_available() is False
    pkg = os.path.join(REPO, "gala_tpu_torch")
    users = sorted(os.path.relpath(os.path.join(d, f), pkg)
                   for d, _, files in os.walk(pkg) for f in files if f.endswith(".py")
                   and "toolchain_available" in open(os.path.join(d, f)).read())
    assert users == [os.path.join("ops", "kernels", "_build.py")]


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
def test_unported_options_raise(what, monkeypatch):
    """Each of these options once raised, naming its ROADMAP item; each is
    ported now and held against gala_tpu here.  Attention on 'dense': it
    builds no attention layout and runs the unfused chain, as gala_tpu
    does, and its forward matches gala_tpu's
    (the 6-epoch parity is in tests/test_torch_edge.py).  bf16 is ported:
    the features are bf16, the params f32, and the bf16 logits match
    gala_tpu's dtype=jnp.bfloat16 within 4e-2 of the largest (the rest of
    the bf16 parity is in tests/test_torch_bf16.py).  Sampling is ported:
    dynamic sampling (k = 4) compiles on 'bell' with its sampling inputs
    and its logits match gala_tpu's (the rest of the sampling parity is in
    tests/test_torch_sampling.py).  int64 is ported: use_long builds the
    full graph with int64 edge ids and int64 unit starts, and its logits
    match gala_tpu's int32 ones (gala_tpu's own int64 run needs x64 mode:
    tests/test_torch_long.py).  col_tile is ported: every layout's units
    lie in one column tile, and the forwards match gala_tpu's with the
    directive forced past its TPU memory gate (tests/test_torch_col_tile.py
    has the rest).  pallas_bell is ported as gala_tpu runs it: the bell
    layout (gala_tpu's Pallas kernels on it are gated off at this size,
    so its XLA route runs, as its own tests run it on the CPU), and the
    forwards match gala_tpu's at strategy='pallas_bell'."""
    spec = parse_source(GAT_DSL if what.startswith("attention") else GCN_DSL)
    kw = {"bf16": {"dtype": torch.bfloat16}, "int64": {"use_long": True},
          "pallas_bell": {"strategy": "pallas_bell"},
          "attention on dense": {"strategy": "dense"}}.get(what, {})
    if what == "sampling":
        spec.compute.sample_dynamic = 4
    if what == "col_tile":
        spec.col_tile = 64
    if what in ("int64", "col_tile"):
        from gala_tpu.dsl.parser import parse_source as jparse_source

        jspec = jparse_source(GCN_DSL)
        jspec.col_tile = spec.col_tile
        monkeypatch.setenv("GALA_FORCE_COL_TILE", "1")  # gala_tpu's TPU memory gate
        jcm = gala_tpu.compile_model(jspec, mode="train", data=_data(jax_dataset),
                                     strategy="bell")
        tcm = gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), strategy="bell",
                                           device="cpu", **kw)
        g = tcm.full_graphs[0]
        if what == "int64":
            assert g.row_ptr.dtype == g.t_row_ptr.dtype == torch.int64
        else:
            u = g.bell.units
            tiles = g.bell.flat_cols.long()[u.start[u.length > 0]] // 64
            assert u.n_units > g.n_nodes
            assert bool((tiles[1:] >= tiles[:-1]).all())
        assert all(t.bell.units.start.dtype == torch.int64
                   for t in tcm.full_graphs + tcm.train_graphs)
        _forwards_match(jcm, tcm, jax.device_get(jcm.make_params(0)))
        return
    if what == "bf16":
        jcm = gala_tpu.compile_source(GCN_DSL, mode="train", data=_data(jax_dataset),
                                      strategy="bell", dtype=jax.numpy.bfloat16)
        tcm = gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), strategy="bell",
                                           device="cpu", **kw)
        assert tcm.x.dtype == torch.bfloat16
        jparams = jax.device_get(jcm.make_params(0))
        params = params_from_jax(jparams)
        assert all(p.dtype == torch.float32 for p in params.parameters())
        with torch.no_grad():
            got = tcm.forward(params, tcm.full_graphs, tcm.invariant(tcm.full_graphs, tcm.x))
        want = np.asarray(jax.jit(jcm.forward)(jparams, jcm.full_graphs, jcm.invariant(
            jcm.full_graphs, jcm.x)).astype(np.float32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=4e-2 * np.abs(want).max())
        return
    if what == "sampling":
        from gala_tpu.dsl.parser import parse_source as jparse_source

        jspec = jparse_source(GCN_DSL)
        jspec.compute.sample_dynamic = 4
        jcm = gala_tpu.compile_model(jspec, mode="train", data=_data(jax_dataset),
                                     strategy="bell")
        tcm = gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), strategy="bell",
                                           device="cpu")
        assert all(g.dyn_f is not None and g.bell.diag is None
                   for g in tcm.full_graphs + tcm.train_graphs)
        _forwards_match(jcm, tcm, jax.device_get(jcm.make_params(0)))
        return
    if what == "pallas_bell":
        jcm = gala_tpu.compile_source(GCN_DSL, mode="train", data=_data(jax_dataset), **kw)
        tcm = gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), device="cpu", **kw)
        _same_program(jcm, tcm)
        assert all(g.strategy == "bell" for g in tcm.full_graphs + tcm.train_graphs)
        _forwards_match(jcm, tcm, jax.device_get(jcm.make_params(0)))
        return
    if what == "attention on dense":
        jcm = gala_tpu.compile_source(GAT_DSL, mode="train", data=_data(jax_dataset), **kw)
        tcm = gala_tpu_torch.compile_model(spec, data=_data(torch_dataset), device="cpu", **kw)
        assert tcm.full_graphs[0].strategy == "dense" and tcm.full_graphs[0].attn is None
        jparams = jax.device_get(jcm.make_params(0))
        with torch.no_grad():
            got = tcm.forward(params_from_jax(jparams), tcm.full_graphs,
                              tcm.invariant(tcm.full_graphs, tcm.x))
        want = jax.jit(jcm.forward)(jparams, jcm.full_graphs,
                                    jcm.invariant(jcm.full_graphs, jcm.x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    raise AssertionError(f"no case for {what!r}")


def test_compiled_model_run_prints_the_csv_line(models):
    """Two fields, inference and train seconds per epoch, each finite and
    positive.  Their order is not checked: they are two wall-clock means,
    and under parallel test workers either may come out larger."""
    _, tcm, _ = models
    parts = tcm.run(iters=7).split(",")
    assert len(parts) == 2
    assert all(math.isfinite(float(p)) and float(p) > 0 for p in parts)


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
                                     data=_data(torch_dataset), strategy="bell", device="cpu")


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


def _gat_params_block_heads():
    """gala_tpu models/gat params at H = 4 (24 features, 4 heads of 8, 5
    classes) whose last layer repeats head 0 four times (so its mean over
    heads is one head's output), and the same model in examples/gat.txt's
    compiled layout: the hidden layer's attention weights (32, 4)
    block-diagonal, head h reading its own 8 columns; the last layer one
    head."""
    from gala_tpu.models import gat as jgat

    hp = jax.device_get(jgat.init(jax.random.key(2), 24, [8], 5, n_heads=4))
    fc1, al1, ar1 = hp["fc"][1], hp["attn_l"][1], hp["attn_r"][1]
    hp["fc"][1] = {"w": np.tile(fc1["w"][:, :5], (1, 4)), "b": np.tile(fc1["b"][:5], 4)}
    for a in (al1, ar1):
        a["w"], a["b"] = np.tile(a["w"][:1], (4, 1)), np.tile(a["b"][:1], 4)

    def block(a):
        w = np.zeros((32, 4), np.float32)
        for h in range(4):
            w[h * 8 : (h + 1) * 8, h] = a["w"][h]
        return {"w": w, "b": a["b"]}

    compiled = {
        "weight1": hp["fc"][0], "attenLWeight1": block(hp["attn_l"][0]),
        "attenRWeight1": block(hp["attn_r"][0]),
        "weight2": {"w": fc1["w"][:, :5], "b": fc1["b"][:5]},
        "attenLWeight2": {"w": al1["w"][0][:, None], "b": al1["b"][:1]},
        "attenRWeight2": {"w": ar1["w"][0][:, None], "b": ar1["b"][:1]},
    }
    return hp, compiled


def test_multihead_unfused_fallback_runs_head_by_head():
    """examples/gat.txt (attention_heads(4)) on 'dense' has no fused layout
    and runs the unfused fallback; each head must weight its own slice of
    the features with its own softmax.  Against the same spec on 'bell'
    (the fused op; rows relabelled by bell_order) and against gala_tpu's
    models/gat.py forward (its per-head unfused loop) on the same weights,
    within 1e-5.  The fallback that used head 0's scores for every head
    differed by up to 1.53 here."""
    from gala_tpu.models import gat as jgat
    from gala_tpu.ops.graph import Graph as JGraph
    from gala_tpu_torch.data.ell import bell_order

    hp, compiled = _gat_params_block_heads()
    params = params_from_jax(compiled)
    out = {}
    for strategy in ("dense", "bell"):
        cm = gala_tpu_torch.compile_model(_gat_example(), mode="train", data=_data(torch_dataset),
                                          strategy=strategy, device="cpu")
        assert (cm.full_graphs[0].attn is None) == (strategy == "dense")
        with torch.no_grad():
            out[strategy] = cm.forward(params, cm.full_graphs,
                                       cm.invariant(cm.full_graphs, cm.x)).numpy()
    slopes = {float(n.params[0]) for n in cm.program.all_nodes() if n.op.name == "FUSED_ATTENTION"}
    host, feats, _, _ = _data(torch_dataset)
    n = host.n_rows
    order = bell_order(host, split_diag=False)
    np.testing.assert_allclose(out["bell"][:n], out["dense"][order], **TOL)

    jhost, jfeats, _, _ = _data(jax_dataset)
    jg = JGraph.from_host(jhost, strategy="dense")
    want = jgat.forward(hp, [jg, jg], jg.pad_nodes(jfeats), negative_slope=slopes.pop(),
                        n_heads=4)
    np.testing.assert_allclose(out["dense"][:n], np.asarray(want)[:n], **TOL)
