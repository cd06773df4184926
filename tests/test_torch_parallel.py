"""The port's sharded path (gala_tpu_torch.parallel) against gala_tpu's, on
the CPU.

gala_tpu runs on the conftest's 8 virtual CPU devices; the port runs as 4
gloo ranks on the CPU, spawned once for the module
(parallel.multihost.spawn with parallel.worker.run_jobs, a FileStore in
tmp_path), each rank writing its results for the tests to compare.  The
spawned ranks import neither JAX nor gala_tpu.

Tolerances: each parallel.ops function, forward and gradients, against
gala_tpu's single-device op at rtol 1e-5, atol 1e-6 (f32, sums in
another order); shard_compiled's logits and gradients against gala_tpu's
shard_compiled at rtol = atol = 2e-4 (tests/test_spmd_compiled.py's),
bf16 within 4e-2 of the largest (tests/test_torch_train.py's bf16
bound); 8 training epochs' losses at rtol 1e-4; make_sharded_train_step's
3 losses at rtol 1e-5.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu_torch
from __graft_entry__ import GCN_DSL
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.ops import edge as jedge
from gala_tpu.ops import spmm as jspmm
from gala_tpu.ops.attention import attention_aggregate as jax_attention
from gala_tpu.ops.graph import Graph as JaxGraph
from gala_tpu.parallel.compiled import shard_compiled as jax_shard_compiled
from gala_tpu.parallel.graph import ShardedGraph as JaxSharded
from gala_tpu.parallel.mesh import make_mesh as jax_mesh
from gala_tpu.parallel.train import make_sharded_train_step as jax_train_step
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.parallel import multihost, worker
from gala_tpu_torch.parallel.graph import ShardedGraph
from gala_tpu_torch.parallel.tp import plan_tp, rank_slice

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location("evaluate", os.path.join(REPO, "scripts",
                                                                        "evaluate.py"))
_ev = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_ev)

OP_TOL = dict(rtol=1e-5, atol=1e-6)
SPMD_TOL = dict(rtol=2e-4, atol=2e-4)
DATA = dict(n=300, avg_degree=8, n_feats=24, n_classes=5, seed=7)
OPS = dict(f=8, heads=2, seed=3, slope=0.2)
SPARSE = GCN_DSL + "G = G.is_sparser(true);"


def _dsl(model, **kw):
    return _ev.make_dsl(model, "SpmdTest", hidden=16, iters=8, **kw)


# name: (DSL source, mesh (n, model_axis), shard_compiled options, dtype);
# the "-edge" case runs with the attention_fusion pass off (UNFUSED)
CASES = {
    "gcn-gather": (_dsl("gcn"), (2, 1), {}, None),
    "gcn-halo": (_dsl("gcn"), (2, 1), {"use_halo": True}, None),
    "gcn-bell": (_dsl("gcn"), (2, 1), {"use_bell": True}, None),
    "gat-bell-fused": (_dsl("gat", heads=2), (2, 1), {"use_bell": True}, None),
    "gat-halo-unfused": (_dsl("gat"), (2, 1), {"use_halo": True}, None),
    "gin-bell": (_dsl("gin"), (2, 1), {"use_bell": True}, None),
    "sage-halo": (_dsl("sage"), (2, 1), {"use_halo": True}, None),
    "sparse-gcn-bell-ev": (SPARSE, (2, 1), {"use_bell": True}, None),
    "gat-edge-bell-ev": (_dsl("gat"), (2, 1), {"use_bell": True}, None),
    "gcn-tp-2x2": (_dsl("gcn"), (4, 2), {"use_bell": True}, None),
    # 4 layers: the third FFN is col-split behind parameters, so its
    # copy_to's gradient all_reduce reaches the first two layers' weights
    "gcn4-tp-2x2": (_dsl("gcn", layers=4), (4, 2), {"use_halo": True}, None),
    "gcn-bell-bf16": (_dsl("gcn"), (2, 1), {"use_bell": True}, "bfloat16"),
}
TRAIN_CASE, TRAIN_ITERS = "gcn-bell", 8
STEP = dict(hidden=16, steps=3)


UNFUSED = {"attention_fusion": False}


def _passes(name):
    return UNFUSED if "-edge" in name else {}


def _jax_compile(source, passes):
    from gala_tpu.dsl.parser import parse_source

    spec = parse_source(source)
    for k, v in passes.items():
        setattr(spec.passes, k, v)
    return gala_tpu.compile_model(spec, mode="train", data=jax_dataset(**DATA),
                                  strategy="segment")


@pytest.fixture(scope="module")
def jax_models():
    return {name: _jax_compile(src, _passes(name)) for name, (src, *_rest) in CASES.items()}


def _jobs(tmp, jax_models):
    jobs = [dict(kind="ops", name=f"ops-{s}", mesh=(s, 1), device="cpu",
                 data=("synthetic", DATA), **OPS) for s in (2, 4)]
    for name, (src, mesh, shard, dtype) in CASES.items():
        weights = str(tmp / f"{name}.weights.pkl")
        worker.dump(jax.device_get(jax_models[name].make_params(0)), weights)
        jobs.append(dict(kind="compiled", name=name, mesh=mesh, device="cpu", source=src,
                         data=("synthetic", DATA), strategy="segment", weights=weights,
                         shard=dict(shard, dtype=dtype), passes=_passes(name),
                         iters=TRAIN_ITERS if name == TRAIN_CASE else 0))
    for halo in (False, True):
        jobs.append(dict(kind="train_step", name=f"step-halo{int(halo)}", mesh=(2, 1),
                         device="cpu", data=("synthetic", DATA), halo=halo,
                         weights=str(tmp / "step.weights.pkl"), **STEP))
    return jobs


def _jax_step(halo):
    """gala_tpu's make_sharded_train_step on make_mesh(2): initial params,
    3 losses, final logits and params."""
    g_host, feats, labels, masks = jax_dataset(**DATA)
    mesh = jax_mesh(2)
    sg = JaxSharded.from_host(g_host, 2, use_halo=halo)
    ns = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    put = lambda a: jax.device_put(a, ns)  # noqa: E731
    sg = jax.tree_util.tree_map(put, sg)
    params, opt, step, fwd = jax_train_step(mesh, sg, feats.shape[1], STEP["hidden"],
                                            int(labels.max()) + 1, halo=halo)
    init = jax.device_get(params)
    x, y, tm = (put(np.asarray(sg.pad_nodes(a))) for a in (feats, labels, masks["train"]))
    losses = []
    for _ in range(STEP["steps"]):
        params, opt, loss = step(params, opt, x, y, tm)
        losses.append(float(loss))
    return init, losses, np.asarray(fwd(params, x)), jax.device_get(params)


@pytest.fixture(scope="module")
def step_refs():
    return {halo: _jax_step(halo) for halo in (False, True)}


@pytest.fixture(scope="module")
def results(tmp_path_factory, jax_models, step_refs):
    tmp = tmp_path_factory.mktemp("ranks")
    worker.dump(step_refs[False][0], str(tmp / "step.weights.pkl"))
    jobs = _jobs(tmp, jax_models)
    multihost.spawn(worker.run_jobs, 4, "gloo", jobs, str(tmp), store=str(tmp / "store"))
    return {job["name"]: worker.read_results(str(tmp), job["name"]) for job in jobs}


# --------------------------------------------------------------------------- #
# host arrays and per-rank layouts
# --------------------------------------------------------------------------- #
LAYOUTS = {"halo": dict(use_halo=True),
           "bell": dict(use_bell=True, attention=True, edge_vals=True)}


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_host_arrays_equal_gala_tpu(n_shards, layout):
    g_jax, g_port = jax_dataset(**DATA)[0], torch_dataset(**DATA)[0]
    want = JaxSharded.from_host(g_jax, n_shards, **LAYOUTS[layout])
    got = ShardedGraph.from_host(g_port, n_shards, **LAYOUTS[layout])
    for name in ("src", "dst_local", "vals", "occ", "deg", "src_halo", "send_idx"):
        np.testing.assert_array_equal(getattr(got, name).reshape(-1),
                                      np.asarray(getattr(want, name)).reshape(-1), err_msg=name)
    for name in ("n_shards", "rows_per_shard", "n_pad", "n_nodes", "edges_per_shard",
                 "edges_local", "halo", "use_halo"):
        assert getattr(got, name) == getattr(want, name), name


def _in_range(name, t, hi, lo=0):
    t = t.long()
    assert t.numel() == 0 or (int(t.min()) >= lo and int(t.max()) < hi), (name, lo, hi)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_every_layout_index_is_in_range(n_shards):
    """Every index of every rank's tensors and layouts points inside the
    table it reads: nothing relies on an out-of-range read clamping."""
    g = torch_dataset(**DATA)[0]
    sg = ShardedGraph.from_host(g, n_shards, **LAYOUTS["bell"])
    for s in range(n_shards):
        lg = sg.local(s, "cpu")
        r, es, n_tab = lg.rows_per_shard, lg.edges_per_shard, lg.n_tab
        _in_range("src", lg.src, sg.n_pad)
        _in_range("dst_local", lg.dst_local, r + 1)
        _in_range("src_halo local block", lg.src_halo[: lg.edges_local], r + 1)
        _in_range("src_halo remote block", lg.src_halo[lg.edges_local :], n_tab, lo=r)
        _in_range("send_idx", lg.send_idx, r)
        # forward layouts read the table (n_tab + 1 rows, zero row n_tab) and
        # write the r + 1 output rows; transposes read dz (r + 1 rows)
        for name, lay, n_src, n_out in (("bell", lg.bell, n_tab + 1, r + 1),
                                        ("t_bell", lg.t_bell, r + 1, n_tab + 1),
                                        ("attn.fwd", lg.attn.fwd, n_tab + 1, r + 1),
                                        ("attn.t", lg.attn.t, r + 1, n_tab + 1)):
            n_slots = lay.flat_cols.shape[0]
            _in_range(f"{name}.flat_cols", lay.flat_cols, n_src)
            _in_range(f"{name}.row_node", lay.row_node, n_out - 1)
            _in_range(f"{name}.out_index", lay.out_index, n_out)
            assert int((lay.row_start + lay.row_len).max()) <= n_slots
            u = lay.units
            _in_range(f"{name}.units.node", u.node, n_out - 1)
            assert int((u.start + u.length).max()) <= n_slots
            _in_range(f"{name}.units.part", u.part, max(u.n_partials, 1), lo=-1)
        ev = lg.ev
        _in_range("edge_perm", ev.edge_perm, es + 1)
        _in_range("t_edge_perm", ev.t_edge_perm, es + 1)
        _in_range("slot_src", ev.slot_src, n_tab + 1)
        _in_range("slot_dst", ev.slot_dst, r)
        _in_range("slot_of_edge", ev.slot_of_edge, lg.bell.flat_cols.shape[0] + 1)
        # the slot maps invert each other on the real edges
        real = lg.occ.numpy() > 0
        soe = ev.slot_of_edge.numpy()
        assert np.array_equal(ev.edge_perm.numpy()[soe[real]], np.nonzero(real)[0])
        assert (soe[~real] == lg.bell.flat_cols.shape[0]).all()


# --------------------------------------------------------------------------- #
# parallel.ops against gala_tpu's single-device ops
# --------------------------------------------------------------------------- #
def _single_device_refs():
    """Each op's output and gradients (of <out, cot>) by gala_tpu on one
    device, on op_inputs: {op: (out, grads by input)}, outputs node- or
    edge-indexed (host CSR edge order)."""
    g = jax_dataset(**DATA)[0]
    n, e = g.n_rows, g.n_edges
    inp = worker.op_inputs(n, e, OPS["f"], OPS["heads"], OPS["seed"])
    seg = JaxGraph.from_host(g, strategy="segment", edge_vals=True)
    bell = JaxGraph.from_host(g, strategy="bell", attention=True)
    node = lambda a, gg=seg: jnp.asarray(np.asarray(gg.pad_nodes(a)))  # noqa: E731

    def edge(a):
        return jnp.asarray(np.concatenate([a, np.zeros(seg.e_pad - e, np.float32)]))

    x, cot = node(inp["x"]), node(inp["cot"])
    ev, cot_e = edge(inp["evals"]), edge(inp["cot_edge"])
    vl, vr = node(inp["vl"][:, :1]), node(inp["vr"][:, :1])
    fns = {
        "spmm": (lambda a: jspmm.spmm(seg, a), (x,), cot),
        "spmm_ev": (lambda v, a: jspmm.spmm_ev(seg, v, a), (ev, x), cot),
        "sddvv_add": (lambda a, b: jedge.sddvv_add(seg, a, b), (vl, vr), cot_e),
        "sddvv_mul": (lambda a, b: jedge.sddvv_mul(seg, a, b), (vl, vr), cot_e),
        "edge_softmax": (lambda a: jedge.edge_softmax(seg, a), (ev,), cot_e),
        "attention": (lambda a, b, c: jax_attention(bell.n_pad, bell.c_pad, OPS["slope"],
                                                    bell.attn, a, b, c),
                      (node(inp["x"], bell), node(inp["vl"], bell), node(inp["vr"], bell)),
                      node(inp["cot"], bell)),
    }
    out = {}
    for name, (fn, args, c) in fns.items():
        val = fn(*args)
        grads = jax.grad(lambda *a: jnp.sum(fn(*a) * c), argnums=tuple(range(len(args))))(*args)
        out[name] = (np.asarray(val), [np.asarray(gr) for gr in grads])
    return g, out


@pytest.fixture(scope="module")
def op_refs():
    return _single_device_refs()


OP_CASES = [(lay, op) for lay, ops in (
    ("gather", ("spmm", "spmm_ev", "sddvv_add", "sddvv_mul", "edge_softmax", "attention")),
    ("halo", ("spmm", "spmm_ev", "attention")),
    ("bell", ("spmm", "spmm_ev", "attention"))) for op in ops]
_EDGE_OUT = ("sddvv_add", "sddvv_mul", "edge_softmax")
_EDGE_IN = {"spmm_ev": (0,), "edge_softmax": (0,)}


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("layout,op", OP_CASES)
def test_op_matches_single_device(results, op_refs, n_shards, layout, op):
    g, refs = op_refs
    n = g.n_rows
    want_out, want_grads = refs[op]
    ranks = results[f"ops-{n_shards}"]
    assert sorted(ranks) == list(range(n_shards))
    got = [ranks[s][f"{layout}/{op}"] for s in range(n_shards)]
    g_port = torch_dataset(**DATA)[0]
    eid = worker.edge_ids(g_port, ShardedGraph.from_host(g_port, n_shards))

    def to_global(parts, is_edge):
        if not is_edge:
            return np.concatenate(parts)[:n]
        out = np.zeros(g.n_edges, np.float32)
        for s, p in enumerate(parts):
            out[eid[s][eid[s] >= 0]] = p[eid[s] >= 0]
        return out

    got_out = to_global([p["out"] for p in got], op in _EDGE_OUT)
    ref_out = want_out[: g.n_edges] if op in _EDGE_OUT else want_out[:n]
    np.testing.assert_allclose(got_out, ref_out, **OP_TOL)
    for i, want in enumerate(want_grads):
        is_edge = i in _EDGE_IN.get(op, ())
        parts = [p["grads"][i] for p in got]
        if op in ("sddvv_add", "sddvv_mul"):
            parts = [p[:, :1] for p in parts]
        got_g = to_global(parts, is_edge)
        np.testing.assert_allclose(got_g, want[: g.n_edges] if is_edge else want[:n],
                                   err_msg=f"gradient {i}", **OP_TOL)


# --------------------------------------------------------------------------- #
# shard_compiled against gala_tpu's shard_compiled
# --------------------------------------------------------------------------- #
def _jax_sharded(cm, mesh, shard, dtype):
    kw = dict(shard)
    if dtype:
        kw["dtype"] = jnp.bfloat16
    return jax_shard_compiled(cm, mesh=jax_mesh(*mesh), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_shard_compiled_matches_gala_tpu(results, jax_models, case):
    src, mesh, shard, dtype = CASES[case]
    cm = jax_models[case]
    ranks = results[case]
    assert len(ranks) == mesh[0]
    sm = _jax_sharded(cm, mesh, shard, dtype)
    params = cm.make_params(0)
    n = cm.host_graph.n_rows
    first = ranks[0]
    if shard.get("use_bell"):
        assert first["layouts"]["bell"]
    if case.startswith("gat-bell"):
        assert first["layouts"]["attn"]
    if case.endswith("bell-ev"):
        assert first["layouts"]["ev"]
    if mesh[1] > 1:
        assert first["plan"], "the TP case must split its FFNs"

    def loss_spmd(p):
        carry = sm.invariant(sm.full_graphs, sm.x)
        out = sm.forward(p, sm.full_graphs, carry)
        return jnp.sum(out[:n].astype(jnp.float32) ** 2), out

    with sm.mesh:
        (_, logits), grads = jax.jit(jax.value_and_grad(loss_spmd, has_aux=True))(params)
    want = np.asarray(logits, np.float32)[:n]
    by_d = {}
    for r in ranks.values():
        by_d.setdefault(r["coords"][0], r["logits"])
        if r["coords"][1]:  # model ranks hold the same logits
            np.testing.assert_array_equal(r["logits"], by_d[r["coords"][0]])
    got = np.concatenate([by_d[d] for d in sorted(by_d)])[:n]
    want_g = jax.device_get(grads)
    got_g = worker.assemble(ranks, "grads")
    if dtype:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-2 * scale)
        for name in want_g:
            for k in want_g[name]:
                w = np.asarray(want_g[name][k], np.float32)
                np.testing.assert_allclose(got_g[name][k], w, rtol=0,
                                           atol=4e-2 * float(np.abs(w).max()))
        return
    np.testing.assert_allclose(got, want, **SPMD_TOL)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                         **SPMD_TOL), got_g, want_g)


def test_training_matches_gala_tpu(results, jax_models):
    src, mesh, shard, dtype = CASES[TRAIN_CASE]
    sm = _jax_sharded(jax_models[TRAIN_CASE], mesh, shard, dtype)
    want = sm.train(iters=TRAIN_ITERS)
    for r in results[TRAIN_CASE].values():
        np.testing.assert_allclose(r["losses"], want.losses, rtol=1e-4)
        assert len(r["accuracies"]) == len(want.accuracies)
        np.testing.assert_allclose(r["accuracies"], want.accuracies, atol=1e-6)


@pytest.mark.parametrize("halo", [False, True])
def test_sharded_train_step_matches_gala_tpu(results, step_refs, halo):
    _, losses, logits, params = step_refs[halo]
    ranks = results[f"step-halo{int(halo)}"]
    n = DATA["n"]
    for r in ranks.values():
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    got = np.concatenate([ranks[d]["logits"] for d in sorted(ranks)])[:n]
    np.testing.assert_allclose(got, logits[:n], rtol=1e-4, atol=1e-5)
    p = ranks[0]["params"]
    np.testing.assert_allclose(p["layer1"]["w"], params["w1"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p["layer2"]["w"], params["w2"], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# planner and guards
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["gcn", "gat", "gin", "sage"])
def test_tp_plan_equals_gala_tpu(model):
    from gala_tpu.parallel.tp import plan_tp as jax_plan_tp

    src = _dsl(model)
    jcm = gala_tpu.compile_source(src, mode="train", data=jax_dataset(**DATA), strategy="segment")
    tcm = gala_tpu_torch.compile_source(src, mode="train", data=torch_dataset(**DATA),
                                        strategy="segment", device="cpu")
    env = {-1: 24, -2: 5}
    for n_model in (1, 2, 4):
        assert plan_tp(tcm.program, env, n_model) == jax_plan_tp(jcm.program, env, n_model)


def test_rank_slice_partitions_each_weight():
    w, b = np.arange(24.0).reshape(4, 6), np.arange(6.0)
    col = [rank_slice("col", "w", w, m, 2) for m in range(2)]
    np.testing.assert_array_equal(np.concatenate(col, axis=1), w)
    np.testing.assert_array_equal(np.concatenate([rank_slice("col", "b", b, m, 2)
                                                  for m in range(2)]), b)
    np.testing.assert_array_equal(np.concatenate([rank_slice("row", "w", w, m, 2)
                                                  for m in range(2)]), w)
    np.testing.assert_array_equal(rank_slice("row", "b", b, 1, 2), b)
    np.testing.assert_array_equal(rank_slice(None, "w", w, 1, 2), w)


def test_dynamic_sampling_raises():
    from gala_tpu_torch.ops.spmm import spmm_sampled
    from gala_tpu_torch.parallel.compiled import shard_compiled

    cm = gala_tpu_torch.compile_source(GCN_DSL + "aggrFn=aggrFn.sample(4).dynamic();",
                                       data=torch_dataset(**DATA), device="cpu")
    with pytest.raises(NotImplementedError, match="single-chip only"):
        shard_compiled(cm, mesh=object())
    g = ShardedGraph.from_host(torch_dataset(**DATA)[0], 2).local(0, "cpu")
    with pytest.raises(NotImplementedError, match="single-chip only"):
        spmm_sampled(g, torch.zeros(g.rows_per_shard, 4), 4, 5, 7)


def test_nccl_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: nccl can run")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        multihost.spawn(worker.run_jobs, 2, "nccl", [], str(tmp_path))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        multihost.check_backend("nccl")


def test_mesh_row_range_and_replicas():
    from gala_tpu_torch.parallel.mesh import Mesh, node_rows, replicated

    mesh = Mesh(shape={"data": 2, "model": 2}, coords=(1, 0), rank=2, data_group=None,
                model_group=None, device=torch.device("cpu"), backend="gloo")
    assert node_rows(mesh, 8) == range(8, 16)
    assert list(replicated(mesh)) == [0, 1, 2, 3]
