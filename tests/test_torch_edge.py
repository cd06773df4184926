"""The edge-valued aggregation path of gala_tpu_torch against gala_tpu, on
the CPU: the 'ell' and 'segment' layouts and the edge lists, the edge ops
(ops.edge), spmm and spmm_ev on every strategy with their gradients, the
SDDMM's plain version, and the two compiled programs that run them: GAT
with the attention chain left unfused, and GCN with the sparsity-aware
rewrite (`G = G.is_sparser(true);`).

Inputs come from numpy seeds, the same on both sides; JAX runs its XLA
executors on the CPU and the port the plain versions its wrappers run
for CPU tensors.  Tolerances: layouts and edge lists are compared
exactly; single ops rtol = atol = 1e-5 (f32 on both sides, sums in
another order); the compiled programs take tests/test_torch_train.py's
(rtol 1e-5 for a forward, 1e-4 for losses over 6 Adam steps, 1e-3 for
the final weights) and rtol 1e-4 for parameter gradients, which sum over
every node."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu.ops.edge as JE
import gala_tpu_torch
import gala_tpu_torch.ops.edge as TE
from __graft_entry__ import GAT_DSL, GCN_DSL
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.dsl.parser import parse_source as jparse_source
from gala_tpu.models import gat as jgat
from gala_tpu.ops.graph import Graph as JGraph
from gala_tpu.ops.spmm import sddmm_edges as jsddmm_edges
from gala_tpu.ops.spmm import spmm as jspmm
from gala_tpu.ops.spmm import spmm_ev as jspmm_ev
from gala_tpu.train import masked_cross_entropy as jmasked_ce
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.dsl.parser import parse_source
from gala_tpu_torch.models import gat as tgat
from gala_tpu_torch.ops import spmm as TS
from gala_tpu_torch.ops.graph import Graph as TGraph
from gala_tpu_torch.ops.kernels import sddmm as KS
from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm_rows_reference
from gala_tpu_torch.train import masked_cross_entropy
from gala_tpu_torch.weights import params_from_jax
from tests.test_torch_graph import CASES, host_graph
from tests.test_torch_train import _data, _forwards_match, _training_matches

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
STRATEGIES = ["dense", "ell", "segment", "segment_scan", "bell"]
GCN_SPARSER = GCN_DSL + "\nG = G.is_sparser(true);\n"


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def graph_pair(case: str, strategy: str):
    """The case graph built by each package with edge values."""
    gj, und = host_graph(case, "jax")
    gt, _ = host_graph(case, "torch")
    return (JGraph.from_host(gj, strategy=strategy, undirected=und, edge_vals=True),
            TGraph.from_host(gt, strategy=strategy, undirected=und, device="cpu",
                             edge_vals=True))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #
def edge_lists_match(jg, tg):
    assert (tg.e_pad, tg.n_edges, tg.n_pad, tg.c_pad) == (jg.e_pad, jg.n_edges, jg.n_pad,
                                                          jg.c_pad)
    for name in ("src", "dst", "vals", "t_src", "t_dst", "t_vals", "t_perm", "row_ptr",
                 "t_row_ptr", "deg"):
        _eq(getattr(tg, name), getattr(jg, name))


def ell_matches(jg, tg):
    for side, lay in (("", tg.ell), ("t_", tg.t_ell)):
        k = lay.k
        _eq(lay.flat_cols.view(-1, k), getattr(jg, f"{side}ell_cols"))
        _eq(lay.flat_vals.view(-1, k), getattr(jg, f"{side}ell_vals"))
        _eq(lay.perm.view(-1, k), getattr(jg, f"{side}ell_perm"))
        _eq(lay.mask, np.asarray(getattr(jg, f"{side}ell_perm")).reshape(-1) != jg.e_pad - 1)


def descriptors_cover_real_slots(lay, vrow=None):
    """Every described slot once, every real slot described; with `vrow`
    (ELL) each described slot's virtual row belongs to the row's node."""
    start, length, node = (t.numpy().astype(np.int64) for t in (lay.row_start, lay.row_len,
                                                                lay.row_node))
    slots = np.concatenate([np.arange(s, s + n) for s, n in zip(start, length)])
    assert np.unique(slots).size == slots.size
    real = np.flatnonzero(lay.mask.numpy()) if lay.mask is not None else np.arange(
        lay.flat_cols.shape[0])
    assert np.isin(real, slots).all()
    np.testing.assert_array_equal(np.sort(node), np.arange(lay.n_real))
    if vrow is not None:
        owner = np.repeat(node, length)
        np.testing.assert_array_equal(np.asarray(vrow)[slots // lay.k], owner)


@pytest.mark.parametrize("case", CASES)
def test_ell_layout_matches_jax(case):
    jg, tg = graph_pair(case, "ell")
    assert tg.strategy == jg.strategy == "ell"
    edge_lists_match(jg, tg)
    ell_matches(jg, tg)
    descriptors_cover_real_slots(tg.ell, jg.ell_vrow)
    descriptors_cover_real_slots(tg.t_ell, jg.t_ell_vrow)


@pytest.mark.parametrize("case", CASES)
def test_segment_layout_is_the_padded_edge_list(case):
    jg, tg = graph_pair(case, "segment")
    edge_lists_match(jg, tg)
    for lay, dst, rows in ((tg.seg, jg.dst, tg.n_pad), (tg.t_seg, jg.t_dst, tg.c_pad)):
        assert lay.n_real == rows and int(lay.row_len.sum()) == tg.e_pad
        descriptors_cover_real_slots(lay)
        # each slot's destination is its row's node: the padding edges
        # are the phantom row's
        np.testing.assert_array_equal(np.repeat(lay.row_node.numpy(), lay.row_len.numpy()),
                                      np.asarray(dst))
    assert tg.seg.flat_cols is tg.src and tg.t_seg.perm is tg.t_perm


def test_ell_descriptors_refuse_uncovered_slots():
    from gala_tpu_torch.data.ell import build_ell
    from gala_tpu_torch.ops.graph import SlotRows

    host, _ = host_graph("directed", "torch")
    he = build_ell(host, phantom_col=host.n_cols, phantom_row=host.n_rows,
                   pad_edge_id=10**6)
    SlotRows.from_ell(he, host.n_rows, host.n_edges, 10**6, "cpu")
    with pytest.raises(ValueError, match="cover"):
        SlotRows.from_ell(he, host.n_rows, host.n_edges + 1, 10**6, "cpu")
    shuffled = he.vrow.copy()
    shuffled[: he.n_virtual] = shuffled[: he.n_virtual][::-1]
    with pytest.raises(ValueError, match="consecutive"):
        SlotRows.from_ell(type(he)(**{**vars(he), "vrow": shuffled}), host.n_rows, host.n_edges,
                     10**6, "cpu")


@pytest.mark.parametrize("strategy,edge_vals,kept", [("bell", False, False),
                                                     ("bell", True, True),
                                                     ("dense", False, True)])
def test_edge_lists_are_kept_where_gala_tpu_keeps_them(strategy, edge_vals, kept):
    gj, und = host_graph("directed", "jax")
    gt, _ = host_graph("directed", "torch")
    jg = JGraph.from_host(gj, strategy=strategy, undirected=und, edge_vals=edge_vals)
    tg = TGraph.from_host(gt, strategy=strategy, undirected=und, edge_vals=edge_vals)
    assert (jg.src is not None) == (tg.src is not None) == (tg.seg is not None) == kept


# --------------------------------------------------------------------------- #
# ops on the hub graph (an in-hub of 320 edges, an out-hub of 300,
# self-loops, isolated rows, weighted and directed)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=STRATEGIES)
def pair(request):
    return graph_pair("hub_selfloops", request.param)


@pytest.fixture(scope="module")
def seg_pair():
    """The edge ops read the edge lists alone, the same on every strategy."""
    return graph_pair("hub_selfloops", "segment")


@pytest.mark.parametrize("op", ["sddvv_add", "sddvv_mul", "edge_softmax", "sddmm"])
def test_edge_ops_and_their_vjps_match_jax(seg_pair, op):
    jg, tg = seg_pair
    if op == "edge_softmax":
        ins = [_rand(1, tg.e_pad) * 3]
    elif op == "sddmm":
        ins = [_rand(2, tg.c_pad, 7), _rand(3, tg.n_pad, 7)]
    else:
        ins = [_rand(4, tg.c_pad, 1), _rand(5, tg.n_pad, 1)]
    cot = _rand(6, tg.e_pad)
    out, vjp = jax.vjp(lambda *a: getattr(JE, op)(jg, *a), *map(jnp.asarray, ins))
    want = [np.asarray(out)] + [np.asarray(v) for v in vjp(jnp.asarray(cot))]
    targs = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    got = getattr(TE, op)(tg, *targs)
    got.backward(torch.from_numpy(cot))
    for g, w in zip([got.detach()] + [t.grad for t in targs], want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_edge_softmax_sums_to_one_and_masks_padding(seg_pair):
    _, tg = seg_pair
    p = TE.edge_softmax(tg, torch.from_numpy(_rand(7, tg.e_pad)))
    sums = np.bincount(tg.dst.numpy(), weights=p.numpy(), minlength=tg.n_pad)
    deg = tg.deg[:, 0].numpy()
    np.testing.assert_allclose(sums[: tg.n_nodes][deg[: tg.n_nodes] > 0], 1.0, rtol=1e-5)
    masked = TE.mask_padded_edges(tg, p)
    assert not masked[tg.n_edges:].any() and torch.equal(masked[: tg.n_edges], p[: tg.n_edges])
    np.testing.assert_array_equal(TE.leaky_relu(torch.tensor([-2.0, 3.0]), 0.5).numpy(),
                                  np.asarray(JE.leaky_relu(jnp.array([-2.0, 3.0]), 0.5)))


@pytest.mark.parametrize("f", [1, 33])
def test_spmm_and_its_grad_match_jax(pair, f):
    jg, tg = pair
    x = _rand(10 + f, tg.c_pad, f)
    x[tg.n_cols:] = 0.0
    dz = _rand(20 + f, tg.n_pad, f)
    out, vjp = jax.vjp(lambda u: jspmm(jg, u), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TS.spmm(tg, xt)
    got.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(dz))[0]), **TOL)


@pytest.mark.parametrize("f", [1, 33])
def test_spmm_ev_and_its_grads_match_jax(pair, f):
    """Values on every padded edge (the padding edges' too: gala_tpu's
    'segment' and 'dense' forwards read them, its 'ell' masks them)."""
    jg, tg = pair
    x = _rand(30 + f, tg.c_pad, f)
    vals = np.abs(_rand(40 + f, tg.e_pad))
    dz = _rand(50 + f, tg.n_pad, f)
    out, vjp = jax.vjp(lambda v, u: jspmm_ev(jg, v, u), jnp.asarray(vals), jnp.asarray(x))
    dvals, dx = vjp(jnp.asarray(dz))
    vt = torch.from_numpy(vals).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TS.spmm_ev(tg, vt, xt)
    got.backward(torch.from_numpy(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dvals), **TOL)


def test_spmm_ev_runs_no_sddmm_for_values_without_grad(pair, monkeypatch):
    """The sparse-rewrite GCN's values come from the hoisted prefix and need
    no gradient: the backward skips the SDDMM (and, for features that need
    none, the transpose SpMM)."""
    _, tg = pair
    calls = []
    monkeypatch.setattr(TS, "sddmm", lambda *a: calls.append(a) or KS.sddmm(*a))
    x = torch.from_numpy(_rand(60, tg.c_pad, 4)).requires_grad_(True)
    vals = torch.from_numpy(np.abs(_rand(61, tg.e_pad)))
    TS.spmm_ev(tg, vals, x).sum().backward()
    assert calls == [] and x.grad is not None
    TS.spmm_ev(tg, vals.requires_grad_(True), x.detach()).sum().backward()
    assert len(calls) == 1 and vals.grad is not None


def test_spmm_ev_on_bell_needs_the_edge_lists():
    host, und = host_graph("directed", "torch")
    tg = TGraph.from_host(host, strategy="bell", undirected=und)
    with pytest.raises(ValueError, match="edge lists"):
        TS.spmm_ev(tg, torch.ones(tg.e_pad), torch.ones((tg.c_pad, 2)))


def test_rows_reference_matches_the_bin_by_bin_version():
    """The descriptor plain version on a binned layout (hubs, a diagonal,
    an output reorder) against the bin-by-bin one."""
    from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm_reference

    host, _ = host_graph("train_subgraph", "torch")
    tg = TGraph.from_host(host, strategy="bell", undirected=False)
    for lay, rows, n_out in ((tg.bell, tg.c_pad, tg.n_pad), (tg.t_bell, tg.n_pad, tg.c_pad)):
        x = torch.from_numpy(_rand(70, rows, 9))
        np.testing.assert_allclose(bell_spmm_rows_reference(lay, x, n_out).numpy(),
                                   bell_spmm_reference(lay, x, n_out).numpy(), **TOL)


# --------------------------------------------------------------------------- #
# the SDDMM's plain version and wrapper
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("f", [1, 33, 128])
def test_sddmm_reference_matches_jax(seg_pair, f):
    _, tg = seg_pair
    a, b = _rand(80 + f, tg.c_pad, f), _rand(90 + f, tg.n_pad, f)
    want = jsddmm_edges(jnp.asarray(tg.src.numpy()), jnp.asarray(tg.dst.numpy()), a, b)
    got = KS.sddmm(tg.src, tg.dst, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (tg.e_pad,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.slow
def test_sddmm_reference_matches_the_pallas_kernel(seg_pair):
    """gala_tpu's Pallas SDDMM in interpret mode at F = 128 (its operands
    the other way round: a by destination)."""
    from gala_tpu.ops.pallas.sddmm import sddmm_pallas

    _, tg = seg_pair
    x, dz = _rand(100, tg.c_pad, 128), _rand(101, tg.n_pad, 128)
    src, dst = tg.src.numpy()[: tg.n_edges], tg.dst.numpy()[: tg.n_edges]
    want = sddmm_pallas(jnp.asarray(dz), jnp.asarray(x), dst, src, edges_per_chunk=256,
                        interpret=True)
    got = KS.sddmm_reference(tg.src[: tg.n_edges], tg.dst[: tg.n_edges],
                             torch.from_numpy(x), torch.from_numpy(dz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_sddmm_wrapper_checks_its_input():
    _, tg = graph_pair("directed", "segment")
    a, b = torch.zeros((tg.c_pad, 8)), torch.zeros((tg.n_pad, 8))
    KS.counts.reset()
    KS.sddmm(tg.src, tg.dst, a, b)
    assert KS.counts.launches == 0 and KS.counts.reference_calls_on_cuda == 0
    with pytest.raises(TypeError):
        KS.sddmm(tg.src, tg.dst, a.double(), b)
    with pytest.raises(TypeError):
        KS.sddmm(tg.src.long(), tg.dst, a, b)
    with pytest.raises(ValueError, match="width"):
        KS.sddmm(tg.src, tg.dst, a, b[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        KS.sddmm(tg.src, tg.dst, torch.zeros((8, tg.c_pad)).t(), b)
    with pytest.raises(ValueError):
        KS.sddmm(tg.src, tg.dst[:-1], a, b)


# --------------------------------------------------------------------------- #
# the compiled programs
# --------------------------------------------------------------------------- #
PROGRAMS = {
    "gat_unfused": (GAT_DSL, False),
    "gcn_sparser": (GCN_SPARSER, True),
}


def _compile(name, strategy):
    src, _ = PROGRAMS[name]
    jspec, tspec = jparse_source(src), parse_source(src)
    if name == "gat_unfused":
        jspec.passes.attention_fusion = tspec.passes.attention_fusion = False
    jcm = gala_tpu.compile_model(jspec, mode="train", data=_data(jax_dataset), strategy=strategy)
    tcm = gala_tpu_torch.compile_model(tspec, mode="train", data=_data(torch_dataset),
                                       strategy=strategy, device="cpu")
    return jcm, tcm, jax.device_get(jcm.make_params(0))


@pytest.fixture(scope="module", params=["gat_unfused", "gcn_sparser"])
def compiled(request):
    return (*_compile(request.param, "ell"), request.param)


def test_compiled_program_and_layouts_match_jax(compiled):
    jcm, tcm, _, name = compiled
    ops = [n.op.name for n in tcm.program.all_nodes()]
    assert ops == [n.op.name for n in jcm.program.all_nodes()]
    assert tcm.full_graphs[0].strategy == jcm.full_graphs[0].strategy == "ell"
    if name == "gat_unfused":
        assert "FUSED_ATTENTION" not in ops
        assert {"AGGREGATE_EDGE_SUM", "SOFTMAX"} <= set(ops)
    else:
        assert "AGGREGATE_EDGE_MUL" in ops
    assert any(n.op.name == "AGGREGATE_MUL_SUM" and len(n.inputs) == 3
               for n in tcm.program.loop.nodes)
    for jg, tg in zip(jcm.full_graphs[:1] + jcm.train_graphs, tcm.full_graphs[:1]
                      + tcm.train_graphs):
        edge_lists_match(jg, tg)
        ell_matches(jg, tg)


def test_compiled_forwards_match_jax(compiled):
    _forwards_match(*compiled[:3])


def test_compiled_parameter_gradients_match_jax(compiled):
    jcm, tcm, jparams, _ = compiled
    gs, tgs = jcm.full_graphs, tcm.full_graphs

    def jloss(p):
        return jmasked_ce(jcm.forward(p, gs, jcm.invariant(gs, jcm.x)), jcm.labels,
                          jcm.train_mask)

    want = jax.device_get(jax.jit(jax.grad(jloss))(jparams))
    params = params_from_jax(jparams)
    with torch.no_grad():
        carry = tcm.invariant(tgs, tcm.x)
    masked_cross_entropy(tcm.forward(params, tgs, carry), tcm.labels,
                         tcm.train_mask).backward()
    for name, layer in params.items():
        for k, v in layer.items():
            np.testing.assert_allclose(v.grad.numpy(), want[name][k], rtol=1e-4, atol=1e-6)


def test_compiled_training_matches_jax(compiled):
    _training_matches(*compiled[:3])


@pytest.mark.parametrize("name,strategy", [("gat_unfused", "segment"), ("gat_unfused", "bell"),
                                           ("gcn_sparser", "segment_scan"),
                                           ("gcn_sparser", "bell")])
def test_compiled_forward_on_other_strategies_matches_jax(name, strategy):
    """'bell' with edge values takes the segment executor for spmm_ev, as
    gala_tpu does."""
    jcm, tcm, jparams = _compile(name, strategy)
    assert tcm.full_graphs[0].strategy == jcm.full_graphs[0].strategy == strategy
    _forwards_match(jcm, tcm, jparams)


def test_gat_under_auto_picks_dense_and_matches_jax():
    """Below the dense gate gala_tpu builds no attention layout for the
    fused GAT and runs the unfused chain on 'dense'; so does the port."""
    jcm = gala_tpu.compile_source(GAT_DSL, mode="train", data=_data(jax_dataset))
    tcm = gala_tpu_torch.compile_source(GAT_DSL, mode="train", data=_data(torch_dataset),
                                        device="cpu")
    assert tcm.full_graphs[0].strategy == jcm.full_graphs[0].strategy == "dense"
    assert tcm.full_graphs[0].attn is None and tcm.full_graphs[0].src is not None
    jparams = jax.device_get(jcm.make_params(0))
    _forwards_match(jcm, tcm, jparams)
    _training_matches(jcm, tcm, jparams)


@pytest.mark.parametrize("n_heads", [1, 2])
def test_hand_gat_unfused_matches_jax(n_heads):
    """models/gat.forward on 'ell' (no fused layout: the per-head unfused
    branch), weights from gala_tpu's init copied over."""
    jg, tg = graph_pair("hub_selfloops", "ell")
    feats = _rand(110, tg.n_pad, 12)
    jparams = jax.device_get(jgat.init(jax.random.key(0), 12, [8], 5, n_heads=n_heads))
    want = jax.jit(lambda p, x: jgat.forward(p, [jg, jg], x, n_heads=n_heads))(jparams, feats)
    with torch.no_grad():
        got = tgat.forward(params_from_jax(jparams), [tg, tg], torch.from_numpy(feats),
                           n_heads=n_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
