"""Graph sampling in gala_tpu_torch against gala_tpu, on the CPU: the
dynamic sampled SpMM (`spmm_sampled`) and its per-slot weights, and the
GCN of __graft_entry__.GCN_DSL under each of table7's schedules
(scripts/evaluate.py job_table7: none, `G=G.sample(20);`,
`aggrFn=aggrFn.sample(20);`, `aggrFn=aggrFn.sample(20).dynamic();`).

The same numpy inputs (seeded) go to both packages; JAX runs its XLA
executors, the port the plain versions its kernel wrappers run for CPU
tensors.  Tolerances, and why:
- `spmm_sampled` and its x-gradient: 1e-5 + 1e-5 * (|A_s| @ |x|), the
  tolerance tests/test_torch_spmm.py holds `spmm` to, relative to the
  summed magnitudes: both sum in f32, in another order (gala_tpu's
  gather form adds a neighbor once per pick, the port multiplies it by
  its pick count), and at k = 300 a row of degree 1 sums one value 300
  times, so the error grows with the sum of the magnitudes, not with the
  result.
- the weights: bitwise.  Each is a count (a small integer, exact in f32)
  times one value, on both sides.
- compiled programs: tests/test_torch_train.py's (one forward rtol 1e-5,
  atol 1e-6; 6-epoch losses rtol 1e-4; accuracies atol 1e-6).
- bf16: tests/test_torch_bf16.py's per-row bound, 2^-7 of a row's summed
  magnitudes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu.lowering.lower as jlower
import gala_tpu_torch
import gala_tpu_torch.lowering.lower as tlower
from __graft_entry__ import GCN_DSL
from gala_tpu.data.csr import coo_to_csr as jcoo_to_csr
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.ops.graph import Graph as JGraph
from gala_tpu.ops.spmm import _dyn_counts, _dyn_reweight
from gala_tpu.ops.spmm import spmm_sampled as jspmm_sampled
from gala_tpu_torch.data.csr import coo_to_csr as tcoo_to_csr
from gala_tpu_torch.data.sampling import dynamic_sample_params
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.ops.graph import Graph as TGraph
from gala_tpu_torch.ops.kernels import bell_spmm as KB
from gala_tpu_torch.ops.kernels import dyn_weights as KD
from gala_tpu_torch.ops.spmm import spmm_sampled
from gala_tpu_torch.weights import params_from_jax
from tests.test_torch_train import _data, _forwards_match

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLES = [(4, 5, 7), (9, 13, 2), (300, 17, 5)]  # (k, ra, rb), gala_tpu's own test's
STRATEGIES = ["dense", "ell", "segment", "bell"]
SCHEDULES = {
    "none": "",
    "data": "G=G.sample(20);",
    "kernel": "aggrFn=aggrFn.sample(20);",
    "dynamic": "aggrFn=aggrFn.sample(20).dynamic();",
}


def _coo(weighted: bool):
    """gala_tpu's tests/test_data_utils.py generator: 400 nodes, 3,000
    uniform edges, node 7 an in-hub of 200 more (over 128 slots: a hub of
    the binned layout), a self loop on every node but 399, which has no
    edge at all; with `weighted` the edges carry values in [0.5, 1.5)."""
    rng = np.random.default_rng(11)
    n = 400
    src = rng.integers(0, n - 1, 3000)
    dst = rng.integers(0, n - 1, 3000)
    hub_src = rng.integers(0, n - 1, 200)
    src = np.concatenate([src, hub_src, np.arange(n - 1)])
    dst = np.concatenate([dst, np.full(200, 7), np.arange(n - 1)])
    vals = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32) if weighted else None
    return src, dst, vals, n


def graph_pair(strategy: str, weighted: bool):
    src, dst, vals, n = _coo(weighted)
    jg = JGraph.from_host(jcoo_to_csr(src, dst, vals, n_rows=n), strategy=strategy,
                          dynamic_sample=True)
    tg = TGraph.from_host(tcoo_to_csr(src, dst, vals, n_rows=n), strategy=strategy,
                          device="cpu", dynamic_sample=True)
    return jg, tg


@pytest.fixture(scope="module", params=[(s, w) for s in STRATEGIES for w in (False, True)],
                ids=lambda p: f"{p[0]}-{'weighted' if p[1] else 'unweighted'}")
def pair(request):
    return (*graph_pair(*request.param), *request.param)


def _inputs(tg, f=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tg.c_pad, f)).astype(np.float32)
    x[tg.n_cols:] = 0.0
    dz = rng.normal(size=(tg.n_pad, f)).astype(np.float32)
    dz[tg.n_nodes:] = 0.0
    return x, dz


@pytest.mark.parametrize("k,ra,rb", SAMPLES)
def test_spmm_sampled_and_grad_match_jax(pair, k, ra, rb):
    """Forward and x-gradient on every strategy, k below and above the
    degrees (k = 300 > the hub's 200+ edges: picks repeat)."""
    jg, tg, strategy, _ = pair
    x, dz = _inputs(tg)
    out, vjp = jax.vjp(lambda u: jspmm_sampled(jg, u, k, ra, rb), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dz))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = spmm_sampled(tg, xt, k, ra, rb)
    got.backward(torch.from_numpy(dz))
    assert got.shape == (tg.n_pad, x.shape[1])
    _close(got, out, _magnitudes(tg, x, k, ra, rb))
    _close(xt.grad, jdx, _magnitudes(tg, dz, k, ra, rb, transpose=True))
    assert (tg.bell is not None) == (strategy == "bell")


def _magnitudes(tg, x, k, ra, rb, transpose=False):
    """|A_s| @ |x|: the sampled product on magnitudes (plain version)."""
    bell = tg.strategy == "bell"
    lay = (tg.t_bell if bell else tg.t_seg) if transpose else (tg.bell if bell else tg.seg)
    meta = tg.dyn_t if transpose else tg.dyn_f
    w = KD.dyn_weights(meta.deg, meta.pos, k, ra, rb, lay.flat_vals if bell else None)
    return KB.bell_spmm_rows_reference(lay, torch.from_numpy(np.abs(x)),
                                       tg.c_pad if transpose else tg.n_pad, w.abs()).numpy()


def _close(got, want, scale):
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert (err <= TOL["atol"] + TOL["rtol"] * scale).all(), float(
        (err - TOL["rtol"] * scale).max())


def test_weights_multiply_edge_values_on_bell_only():
    """With weighted edges, 'bell' weights each pick by its edge's value
    and the edge-list strategies do not (gala_tpu's _spmm_dyn_bell and
    _sampled_ell): the two agree on the unweighted graph and differ on
    the weighted one."""
    k, ra, rb = SAMPLES[1]
    outs = {}
    for weighted in (False, True):
        for strategy in ("segment", "bell"):
            _, tg = graph_pair(strategy, weighted)
            x, _ = _inputs(tg)
            outs[strategy, weighted] = spmm_sampled(tg, torch.from_numpy(x), k, ra, rb)
    np.testing.assert_allclose(outs["bell", False], outs["segment", False], **TOL)
    np.testing.assert_allclose(outs["segment", True], outs["segment", False], **TOL)
    assert not np.allclose(outs["bell", True], outs["bell", False], **TOL)


def _jax_bell_slots(bell, meta):
    """gala_tpu's per-segment (d, p) expanded to slots in flat order."""
    ks = list(bell.bin_ks) + ([bell.big_vals.shape[1]] if bell.n_big else [])
    deg = np.concatenate([np.repeat(np.asarray(d)[:, 0], k) for d, k in zip(meta.d, ks)])
    pos = np.concatenate([(np.asarray(p) + np.arange(k)[None, :]).reshape(-1)
                          for p, k in zip(meta.p, ks)])
    return deg, pos


def _flat(bell):
    parts = list(bell.bin_vals) + ([bell.big_vals] if bell.n_big else [])
    return np.concatenate([np.asarray(p).reshape(-1) for p in parts])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("side", ["forward", "transpose"])
def test_bell_slots_and_weights_match_jax_bitwise(weighted, side):
    """The port's per-slot (deg, pos) are gala_tpu's DynMeta expanded to
    slots, the bells hold the same slots (self loops among them), and the
    plain dyn_weights equals gala_tpu's _dyn_reweight slot for slot,
    bitwise, at each (k, ra, rb)."""
    jg, tg = graph_pair("bell", weighted)
    jb, meta, tb, dyn = ((jg.bell, jg.dyn_f, tg.bell, tg.dyn_f) if side == "forward"
                         else (jg.t_bell, jg.dyn_t, tg.t_bell, tg.dyn_t))
    assert tb.diag is None and jb.diag is None
    np.testing.assert_array_equal(tb.flat_cols.numpy(), np.asarray(jb.flat_cols))
    np.testing.assert_array_equal(tb.flat_vals.numpy(), _flat(jb))
    deg, pos = _jax_bell_slots(jb, meta)
    np.testing.assert_array_equal(dyn.deg.numpy(), deg)
    np.testing.assert_array_equal(dyn.pos.numpy(), pos)
    for k, ra, rb in SAMPLES:
        want = _flat(jax.jit(_dyn_reweight, static_argnums=2)(jb, meta, k, ra, rb))
        got = KD.dyn_weights(dyn.deg, dyn.pos, k, ra, rb, tb.flat_vals).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("strategy", ["dense", "ell", "segment"])
def test_edge_list_slots_use_real_degrees(strategy):
    """Off 'bell' the sampling inputs cover the edge-list layouts: each
    slot's degree is its row's real in-degree (0 on the phantom row that
    holds the padding edges and on padding rows) and its position counts
    from its row's start; the transpose's degrees are the out-degrees."""
    _, tg = graph_pair(strategy, True)
    src, dst, _, n = _coo(True)
    for dyn, lay, counts in ((tg.dyn_f, tg.seg, np.bincount(dst, minlength=n)),
                             (tg.dyn_t, tg.t_seg, np.bincount(src, minlength=n))):
        starts, lens = lay.row_start.numpy(), lay.row_len.numpy()
        rows = np.repeat(np.arange(lens.shape[0]), lens)
        real = np.zeros(lens.shape[0], np.int64)
        real[:n] = counts
        np.testing.assert_array_equal(dyn.deg.numpy(), real[rows])
        np.testing.assert_array_equal(dyn.pos.numpy(), np.arange(rows.shape[0]) - starts[rows])
        assert dyn.deg.shape == lay.flat_cols.shape


def test_spmm_sampled_needs_the_sampling_inputs():
    src, dst, vals, n = _coo(False)
    g = TGraph.from_host(tcoo_to_csr(src, dst, vals, n_rows=n), strategy="bell", device="cpu")
    assert g.dyn_f is None and g.bell.diag is not None
    with pytest.raises(ValueError, match="dynamic_sample=True"):
        spmm_sampled(g, torch.zeros((g.c_pad, 4)), 4, 5, 7)


def test_dyn_weights_checks_its_input_and_runs_plain_on_cpu():
    _, tg = graph_pair("bell", False)
    deg, pos = tg.dyn_f.deg, tg.dyn_f.pos
    KD.counts.reset()
    w = KD.dyn_weights(deg, pos, 20, 96, 96)
    assert KD.counts.launches == 0 and KD.counts.reference_calls_on_cuda == 0
    # every real row's weights sum to k: each of its k picks lands on one slot
    sums = torch.zeros(tg.n_pad).index_add_(0, tg.bell.row_node.repeat_interleave(
        tg.bell.row_len.long()), w[torch.cat([torch.arange(s, s + n) for s, n in zip(
            tg.bell.row_start.tolist(), tg.bell.row_len.tolist())])])
    real_deg = np.bincount(_coo(False)[1], minlength=400)
    np.testing.assert_array_equal(sums.numpy()[:400], np.where(real_deg > 0, 20.0, 0.0))
    with pytest.raises(ValueError, match="overflows int32"):
        KD.dyn_weights(deg, pos, 2**30, 5, 7)
    with pytest.raises(ValueError, match=">= 0"):
        KD.dyn_weights(deg, pos, 4, -1, 7)
    with pytest.raises(TypeError):
        KD.dyn_weights(deg.long(), pos, 4, 5, 7)
    with pytest.raises(ValueError):
        KD.dyn_weights(deg, pos, 4, 5, 7, vals=torch.ones(3))


@pytest.mark.parametrize("strategy", ["segment", "bell"])
def test_spmm_sampled_matches_jax_at_bf16(strategy):
    """bf16 features (gala_tpu's dtype=jnp.bfloat16): the weights stay f32
    and round to bf16 in the product, the sums in f32; within 2^-7 of each
    row's summed magnitudes (tests/test_torch_bf16.py's op bound)."""
    jg, tg = graph_pair(strategy, True)
    k, ra, rb = SAMPLES[0]
    x, dz = _inputs(tg, f=33, seed=3)
    x = torch.from_numpy(x).to(torch.bfloat16)
    out, vjp = jax.vjp(lambda u: jspmm_sampled(jg, u, k, ra, rb),
                       jnp.asarray(x.float().numpy(), jnp.bfloat16))
    (jdx,) = vjp(jnp.asarray(dz, jnp.bfloat16))
    xt = x.clone().requires_grad_(True)
    got = spmm_sampled(tg, xt, k, ra, rb)
    got.backward(torch.from_numpy(dz).to(torch.bfloat16))
    assert got.dtype == xt.grad.dtype == torch.bfloat16
    lay, t_lay = (tg.bell, tg.t_bell) if strategy == "bell" else (tg.seg, tg.t_seg)
    for t, j, lay_, meta, inp, n_out in ((got, out, lay, tg.dyn_f, x, tg.n_pad),
                                         (xt.grad, jdx, t_lay, tg.dyn_t,
                                          torch.from_numpy(dz).to(torch.bfloat16), tg.c_pad)):
        w = KD.dyn_weights(meta.deg, meta.pos, k, ra, rb,
                           lay_.flat_vals if strategy == "bell" else None)
        scale = KB.bell_spmm_rows_reference(lay_, inp.float().abs(), n_out, w).numpy()
        err = np.abs(t.detach().float().numpy() - np.asarray(jnp.asarray(j, jnp.float32)))
        assert (err <= 2.0**-7 * scale.max(axis=1, keepdims=True) + 1e-6).all()


# --------------------------------------------------------------------------- #
# compiled GCN under table7's schedules
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=[(m, s) for m in SCHEDULES for s in ("bell", "auto")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def table7(request):
    mode, strategy = request.param
    src = GCN_DSL + SCHEDULES[mode] + "\n"
    jcm = gala_tpu.compile_source(src, mode="train", data=_data(jax_dataset), strategy=strategy)
    tcm = gala_tpu_torch.compile_source(src, mode="train", data=_data(torch_dataset),
                                        strategy=strategy, device="cpu")
    return dict(mode=mode, strategy=strategy, jcm=jcm, tcm=tcm,
                jparams=jax.device_get(jcm.make_params(0)))


def test_table7_program_and_graphs_match_jax(table7):
    """The same program, strategy ('auto' is 'dense' at this size),
    sampled graph and features; dynamic sampling builds every graph with
    its sampling inputs (the bells with the self loops as slots)."""
    jcm, tcm, mode = table7["jcm"], table7["tcm"], table7["mode"]
    assert [n.op.name for n in tcm.program.all_nodes()] == [
        n.op.name for n in jcm.program.all_nodes()]
    want = "bell" if table7["strategy"] == "bell" else "dense"
    graphs = list(zip(tcm.full_graphs[:1] + tcm.train_graphs,
                      jcm.full_graphs[:1] + jcm.train_graphs))
    assert len(graphs) == 3
    for tg, jg in graphs:
        assert tg.strategy == jg.strategy == want
        assert (tg.n_nodes, tg.n_edges, tg.e_pad) == (jg.n_nodes, jg.n_edges, jg.e_pad)
        np.testing.assert_array_equal(tg.deg.numpy(), np.asarray(jg.deg))
        assert (tg.dyn_f is not None) == (mode == "dynamic")
        if want == "bell":
            np.testing.assert_array_equal(tg.bell.flat_cols.numpy(), np.asarray(jg.bell.flat_cols))
            assert (tg.bell.diag is None) == (jg.bell.diag is None) == (mode == "dynamic")
    np.testing.assert_array_equal(tcm.x.numpy(), np.asarray(jcm.x))
    if mode in ("data", "kernel"):
        assert tcm.full_graphs[0].n_edges < _data(torch_dataset)[0].n_edges
        assert int(tcm.full_graphs[0].deg.max()) <= 20


def test_table7_forward_matches_jax(table7):
    """The hoisted prefix, the forward and the row-subset forward on the
    full graph and the training subgraphs, from gala_tpu's weights; for
    dynamic sampling also with an epoch's pair in the carry."""
    jcm, tcm, jparams = table7["jcm"], table7["tcm"], table7["jparams"]
    _forwards_match(jcm, tcm, jparams)
    if table7["mode"] != "dynamic":
        return
    jcarry = {**jax.jit(jcm.invariant)(jcm.full_graphs, jcm.x),
              "_ra": jnp.int32(13), "_rb": jnp.int32(2)}
    with torch.no_grad():
        tcarry = {**tcm.invariant(tcm.full_graphs, tcm.x), "_ra": 13, "_rb": 2}
        got = tcm.forward(params_from_jax(jparams), tcm.full_graphs, tcarry).numpy()
        default = tcm.forward(params_from_jax(jparams), tcm.full_graphs,
                              tcm.invariant(tcm.full_graphs, tcm.x)).numpy()
    # eager: a jit argument's dict keys must sort, and the carry's are
    # int uids beside the pair's names (gala_tpu merges them under its jit)
    want = jcm.forward(jparams, jcm.full_graphs, jcarry)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, default, rtol=1e-5, atol=1e-6)


def _record_epoch_inputs(monkeypatch, module):
    seen = []
    real = module.train

    def train(*args, **kw):
        seen.append(kw.get("epoch_inputs"))
        return real(*args, **kw)

    monkeypatch.setattr(module, "train", train)
    return seen


def test_table7_training_matches_jax(table7, monkeypatch):
    """6 epochs (valid_step 5: epochs 0 and 5 on the full graph, 1-4 on
    the training subgraphs): the losses and accuracies, and for dynamic
    sampling each epoch's (ra, rb) equal to gala_tpu's."""
    jcm, tcm = table7["jcm"], table7["tcm"]
    jseen = _record_epoch_inputs(monkeypatch, jlower)
    tseen = _record_epoch_inputs(monkeypatch, tlower)
    jres = jcm.train(iters=6, warmup=1)
    tres = tcm.train(iters=6, warmup=1, params=params_from_jax(table7["jparams"]))
    assert len(tres.losses) == len(jres.losses) == 6
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    np.testing.assert_allclose(tres.accuracies, jres.accuracies, atol=1e-6)
    if table7["mode"] != "dynamic":
        assert jseen == tseen == [None]
        return
    pairs = [tseen[0](e) for e in range(6)]
    assert pairs == [{"_ra": int(d["_ra"]), "_rb": int(d["_rb"])}
                     for d in map(jseen[0], range(6))]
    assert pairs == [dict(zip(("_ra", "_rb"), dynamic_sample_params(e, 0))) for e in range(6)]
    assert all(type(v) is int for d in pairs for v in d.values())
    assert len({tuple(d.values()) for d in pairs}) > 1


def _stepped_counts(deg, pos, starts, lens, k, ra, rb):
    """The sampled SpMM's counts as its pass 1 makes them
    (csrc/bell_spmm.cu weigh_slots), emulated on the host: each work unit
    (slots [start, start + len) of one row) reads its row's degree d at
    its first slot, steps r through the row's k picks (from rb mod d,
    adding ra mod d and subtracting d on overflow, no division in the
    loop) and counts at each slot the picks at its position; a row of
    degree 0 takes no pick."""
    count = np.zeros(deg.shape, np.float32)
    for s, n in zip(np.asarray(starts).tolist(), np.asarray(lens).tolist()):
        d = int(deg[s]) if n else 0
        if d <= 0:
            continue
        p = pos[s : s + n].astype(np.int64)
        r, step = rb % d, ra % d
        for _ in range(k):
            count[s : s + n] += p == r
            r += step
            if r >= d:
                r -= d
    return count


@pytest.mark.parametrize("k,ra,rb", [(0, 5, 7), (1, 5, 7), (20, 96, 96), (300, 17, 5),
                                     (13, 0, 2**20), (7, 96 * 1000, 31)])
def test_staging_count_matches_the_plain_weights_and_jax(k, ra, rb):
    """The stepped count (each slot a unit of its own) equals
    dyn_weights_reference and gala_tpu's _dyn_counts bit for bit (times
    the values too), on random slots with rows of degree 0, positions at
    or past the degree, k above the degree and ra a multiple of the degree
    (every pick at one position)."""
    rng = np.random.default_rng(k + ra)
    n = 4000
    d = rng.integers(0, 60, n).astype(np.int32)
    d[:200] = 0
    d[200:400] = np.array([1, 2, 3, 4, 6, 8, 12, 16, 24, 32], np.int32)[rng.integers(0, 10, 200)]
    p = (rng.random(n) * (d + 3)).astype(np.int32)  # some at or past the degree
    vals = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    want = _stepped_counts(d, p, np.arange(n), np.ones(n, np.int64), k, ra, rb)
    got = KD.dyn_weights_reference(torch.from_numpy(d), torch.from_numpy(p), k, ra, rb).numpy()
    jx = np.asarray(_dyn_counts(jnp.asarray(d), jnp.asarray(p), k, ra, rb))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(jx.view(np.int32), want.view(np.int32))
    weighted = KD.dyn_weights_reference(torch.from_numpy(d), torch.from_numpy(p), k, ra, rb,
                                        torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(weighted.view(np.int32), (want * vals).view(np.int32))
    assert (want[:200] == 0).all() and (want[p >= d] == 0).all()


@pytest.mark.parametrize("col_tile", [None, 150])
@pytest.mark.parametrize("strategy", ["bell", "segment"])
def test_units_step_their_rows_picks_onto_the_plain_weights(strategy, col_tile):
    """On every sampled layout, forward and transpose, a work unit's slots
    share their row's degree (what lets a lane step through the row's
    picks once for all its slots; with column tiles their positions have
    gaps), and the units' stepped counts equal the plain weights bit for
    bit."""
    src, dst, vals, n = _coo(True)
    tg = TGraph.from_host(tcoo_to_csr(src, dst, vals, n_rows=n), strategy=strategy,
                          device="cpu", dynamic_sample=True, col_tile=col_tile)
    sides = ((tg.bell, tg.dyn_f), (tg.t_bell, tg.dyn_t)) if strategy == "bell" else (
        (tg.seg, tg.dyn_f), (tg.t_seg, tg.dyn_t))
    gaps = 0
    for lay, meta in sides:
        deg, pos = meta.deg.numpy(), meta.pos.numpy()
        starts, lens = lay.units.start.numpy(), lay.units.length.numpy()
        for s, m in zip(starts.tolist(), lens.tolist()):
            if m:  # a row of no slots keeps one unit of none
                assert (deg[s : s + m] == deg[s]).all()
                gaps += pos[s + m - 1] - pos[s] != m - 1
        for k, ra, rb in SAMPLES:
            want = KD.dyn_weights_reference(meta.deg, meta.pos, k, ra, rb).numpy()
            got = _stepped_counts(deg, pos, starts, lens, k, ra, rb)
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (gaps > 0) == (col_tile is not None)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the dispatch sees."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def test_dyn_weights_runs_plain_without_a_card_and_raises_on_one():
    """Without a card dyn_weights is its plain version (no launch); given
    CUDA tensors it raises, naming the sampled SpMM that computes the
    weights on the card, and runs no plain version there."""
    _, tg = graph_pair("segment", True)
    deg, pos = tg.dyn_f.deg, tg.dyn_f.pos
    KD.counts.reset()
    got = KD.dyn_weights(deg, pos, 9, 13, 2)
    assert torch.equal(got, KD.dyn_weights_reference(deg, pos, 9, 13, 2))
    assert KD.counts.launches == 0 and not hasattr(KD, "build")
    with pytest.raises(RuntimeError, match="bell_spmm_sampled"):
        KD.dyn_weights(deg.as_subclass(_OnCard), pos.as_subclass(_OnCard), 9, 13, 2)
    assert KD.counts.launches == 0 and KD.counts.reference_calls_on_cuda == 0
