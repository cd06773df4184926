"""gala_tpu_torch.ops.attention and its kernels' plain versions against
gala_tpu.ops.attention, on the CPU.

One small graph with a hub of in-degree > 128 (3 virtual rows), a source
of out-degree > 128 (a hub of the transpose layout), self-loops and
isolated nodes; inputs from a numpy seed, the same on both sides.

The fast tier holds the port against gala_tpu's default executors (the
XLA chunked forward with the flash statistics, pass 1 of the chunked
backward, pass 2, and `attention_aggregate` under jax.value_and_grad), at
H = 1 and 4 heads of hf = 16 columns.  Tolerance rtol = atol = 1e-4: both
sides compute in f32, the port's plain versions slot by slot and gala_tpu
bin by bin, so sums run in different orders.  The JAX oracles are jitted
and computed once per H.

The Pallas kernels themselves (interpret mode, which takes minutes here)
are the `slow` test at the end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gala_tpu.ops.attention as JA
from gala_tpu.data.csr import coo_to_csr as jcoo_to_csr
from gala_tpu.models import gat as jgat
from gala_tpu.ops.graph import Graph as JGraph
from gala_tpu_torch.data.csr import coo_to_csr as tcoo_to_csr
from gala_tpu_torch.models import gat as tgat
from gala_tpu_torch.ops import attention as TA
from gala_tpu_torch.ops.graph import Graph as TGraph
from gala_tpu_torch.ops.kernels import attn_bell as K
from gala_tpu_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(2)

SLOPE = 0.2
HF = 16
HEADS = [1, 4]
TOL = dict(rtol=1e-4, atol=1e-4)


def attn_coo(seed=5):
    """(src, dst, n) of the test graph: 400 nodes, node 3 an in-hub (300
    extra sources), node 5 an out-hub (200 extra destinations), self-loops
    on every second node below 390, nodes 390-399 isolated; duplicate
    edges dropped (every slot is a distinct softmax term)."""
    rng = np.random.default_rng(seed)
    n, m = 400, 390
    src = np.concatenate([rng.integers(0, m, 4000), rng.integers(0, m, 300), np.full(200, 5),
                          np.arange(0, m, 2)])
    dst = np.concatenate([rng.integers(0, m, 4000), np.full(300, 3), rng.integers(0, m, 200),
                          np.arange(0, m, 2)])
    key = np.unique(src.astype(np.int64) * n + dst)
    return key // n, key % n, n


@pytest.fixture(scope="module")
def graphs():
    src, dst, n = attn_coo()
    jg = JGraph.from_host(jcoo_to_csr(src, dst, None, n_rows=n), strategy="bell", attention=True)
    host = tcoo_to_csr(src, dst, None, n_rows=n)
    tg = TGraph.from_host(host, strategy="bell", attention=True, device="cpu")
    assert tg.attn.fwd.n_big and tg.attn.t.n_big, "the graph must have hubs on both sides"
    return jg, tg, host


def _inputs(g, nh, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return f(g.c_pad, HF), f(g.c_pad, nh), f(g.n_pad, nh), f(g.n_pad, HF)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module", params=HEADS)
def oracle(request, graphs):
    """The JAX side at H heads: inputs, the chunked forward's node tables,
    pass 1's (sds, dvr), pass 2's (dx, dvl) and value_and_grad of
    sum(out * dout)."""
    jg, tg, _ = graphs
    nh = request.param
    x, vl, vr, dout = _inputs(tg, nh, seed=nh)
    ab, n_pad, c_pad = jg.attn, jg.n_pad, jg.c_pad

    fwd = jax.jit(lambda *a: JA._attn_fwd_chunked(ab, *a, SLOPE, n_pad))
    out, vr_bin, m_bin, s_bin, m_node, s_node, flash = fwd(x, vl, vr)

    def pass1_stats(*a, dout):
        # pass 1 of the backward without the flash identity; pass 2 is
        # replaced so the call returns pass 1's node tables
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JA, "_attn_bwd_pass2", lambda ab_, x_, vl_, vr_, m_, s_, sds, dvr, *r:
                       (sds, dvr))
            return JA._attn_bwd_chunked(ab, *a, SLOPE, dout, c_pad, flash=None)

    sds, dvr1 = jax.jit(pass1_stats)(x, vl, vr, vr_bin, m_bin, s_bin, m_node, s_node,
                                     dout=dout)
    pass2 = jax.jit(lambda *a, dout: JA._attn_bwd_pass2(ab, *a, SLOPE, dout, c_pad))
    dx2, dvl2, _ = pass2(x, vl, vr, m_node, s_node, sds, dvr1, dout=dout)

    def loss(x_, vl_, vr_):
        o = JA.attention_aggregate(n_pad, c_pad, SLOPE, ab, x_, vl_, vr_)
        return jnp.sum(o * dout), o

    (_, out_ag), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        x, vl, vr)
    np_ = lambda *a: [np.asarray(v) for v in a]  # noqa: E731
    return dict(
        nh=nh, inputs=(x, vl, vr, dout),
        fwd=np_(out, m_node, s_node, *flash), sds=np.asarray(sds), dvr1=np.asarray(dvr1),
        pass2=np_(dx2, dvl2), out=np.asarray(out_ag), grads=np_(*grads),
    )


def test_host_layout_matches_jax(graphs):
    jg, tg, host = graphs
    from gala_tpu.data.csr import HostCSR as JHostCSR

    jhost = JHostCSR(**{k: getattr(host, k) for k in host.__dataclass_fields__})
    for want, got in zip(JA.build_attention_bell(jhost), TA.build_attention_bell(host)):
        for name in ("flat_cols", "order", "big_vals", "big_vrow"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        for name in ("bin_ks", "bin_counts", "n_big", "identity_order", "diag"):
            assert getattr(got, name) == getattr(want, name), name
        for a, b in zip(got.bin_vals, want.bin_vals, strict=True):
            np.testing.assert_array_equal(a, b)
    for jlay, tlay in ((jg.attn.fwd, tg.attn.fwd), (jg.attn.t, tg.attn.t)):
        np.testing.assert_array_equal(tlay.flat_cols.numpy(), np.asarray(jlay.flat_cols))
        np.testing.assert_array_equal(tlay.big_vrow.numpy(), np.asarray(jlay.big_vrow))
        assert int(tlay.row_len.sum()) == tlay.flat_cols.shape[0]
        assert sorted(tlay.row_node.tolist()) == list(range(tlay.n_real))


def test_fwd_reference_matches_jax(graphs, oracle):
    _, tg, _ = graphs
    x, vl, vr, _ = _t(*oracle["inputs"])
    got = K.attn_fwd_reference(tg.attn.fwd, x, vl, vr, SLOPE, tg.n_pad, flash=True)
    out, m, s, out32, outpos, spos = oracle["fwd"]
    for name, g, w in zip(("out", "m", "s", "outpos", "spos"), got, (out, m, s, outpos, spos)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    np.testing.assert_allclose(got[0].numpy(), out32, **TOL)
    plain = K.attn_fwd_reference(tg.attn.fwd, x, vl, vr, SLOPE, tg.n_pad, flash=False)
    assert plain[3] is None and plain[4] is None
    np.testing.assert_array_equal(plain[0].numpy(), got[0].numpy())


def test_bwd1_reference_matches_jax(graphs, oracle):
    """sds and dvr = A - sds*B against pass 1 of gala_tpu's backward; A and
    B against the flash identity A = slope*sds + (1-slope)<dout, out+>,
    B = slope*sum(p) + (1-slope)s+ from gala_tpu's forward."""
    _, tg, _ = graphs
    x, vl, vr, dout = _t(*oracle["inputs"])
    _, m, s, out32, outpos, spos = oracle["fwd"]
    sds, a, b = K.attn_bwd1_reference(tg.attn.fwd, x, vl, vr, dout, *_t(m, s), SLOPE)
    np.testing.assert_allclose(sds.numpy(), oracle["sds"], **TOL)
    np.testing.assert_allclose((a - sds * b).numpy(), oracle["dvr1"], **TOL)
    nh = oracle["nh"]
    d = oracle["inputs"][3]
    dot = lambda u: (d * u).reshape(d.shape[0], nh, -1).sum(-1)  # noqa: E731
    lay = tg.attn.fwd
    has_edges = np.zeros((tg.n_pad, 1))  # sum(p) is 1 on a node with edges, else 0
    has_edges[lay.row_node.numpy()] = np.add.reduceat(lay.flat_vals.numpy(),
                                                      lay.row_start.numpy())[:, None] > 0
    np.testing.assert_allclose(a.numpy(), SLOPE * dot(out32) + (1 - SLOPE) * dot(outpos), **TOL)
    np.testing.assert_allclose(b.numpy(), SLOPE * has_edges + (1 - SLOPE) * spos, **TOL)


def test_bwd2_reference_matches_jax(graphs, oracle):
    _, tg, _ = graphs
    x, vl, vr, dout = _t(*oracle["inputs"])
    _, m, s, *_ = oracle["fwd"]
    w_tab = torch.cat([dout, vr, *_t(m, s, oracle["sds"])], dim=1)
    got = K.attn_bwd2_reference(tg.attn.t, x, vl, w_tab, SLOPE, tg.c_pad)
    dx, dvl = oracle["pass2"]
    np.testing.assert_allclose(got[:, :HF].numpy(), dx, **TOL)
    np.testing.assert_allclose(got[:, HF:].numpy(), dvl, **TOL)


def test_attention_aggregate_matches_jax(graphs, oracle):
    """Forward and the gradients of sum(out * dout) in x, vl and vr."""
    _, tg, _ = graphs
    x, vl, vr, dout = _t(*oracle["inputs"])
    for t in (x, vl, vr):
        t.requires_grad_(True)
    out = TA.attention_aggregate(tg.n_pad, tg.c_pad, SLOPE, tg.attn, x, vl, vr)
    (out * dout).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), oracle["out"], **TOL)
    for name, t, want in zip(("dx", "dvl", "dvr"), (x, vl, vr), oracle["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name, **TOL)
    with torch.no_grad():
        again = TA.attention_aggregate(tg.n_pad, tg.c_pad, SLOPE, tg.attn, x, vl, vr)
    np.testing.assert_array_equal(again.numpy(), out.detach().numpy())


@pytest.mark.parametrize("n_heads", HEADS)
def test_gat_model_matches_jax(graphs, n_heads):
    """models/gat.forward, weights from gala_tpu's init copied over."""
    jg, tg, _ = graphs
    feats = np.random.default_rng(7).standard_normal((tg.n_pad, 12)).astype(np.float32)
    jparams = jax.device_get(jgat.init(jax.random.key(0), 12, [8], 5, n_heads=n_heads))
    want = jax.jit(lambda p, x: jgat.forward(p, [jg, jg], x, n_heads=n_heads))(jparams, feats)
    with torch.no_grad():
        got = tgat.forward(params_from_jax(jparams), [tg, tg], torch.from_numpy(feats),
                           n_heads=n_heads)
    assert got.shape == (tg.n_pad, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hand = tgat.init(torch.Generator().manual_seed(0), 12, [8], 5, n_heads=n_heads)
    shapes = lambda tree: [np.shape(v) for v in jax.tree_util.tree_leaves(tree)]  # noqa: E731
    assert shapes(params_to_numpy(hand)) == shapes(jparams)


def test_wrappers_refuse_what_the_kernels_do_not_take(graphs):
    _, tg, _ = graphs
    x, vl, vr, _ = _t(*_inputs(tg, 1, seed=0))
    with pytest.raises(TypeError):
        K.attn_fwd(tg.attn.fwd, x.double(), vl, vr, SLOPE, tg.n_pad, False)
    with pytest.raises(ValueError):
        K.attn_fwd(tg.attn.fwd, x, torch.zeros((tg.c_pad, 3)), vr, SLOPE, tg.n_pad, False)
    with pytest.raises(ValueError):
        K.attn_fwd(tg.attn.fwd, x, torch.zeros((tg.c_pad, 9)), vr, SLOPE, tg.n_pad, False)
    with pytest.raises(ValueError):
        K.attn_fwd(tg.attn.fwd, x[:10], vl[:10], vr, SLOPE, tg.n_pad, False)
    with pytest.raises(ValueError):
        K.attn_bwd2(tg.attn.t, x, vl, torch.zeros((tg.n_pad, HF)), SLOPE, tg.c_pad)


@pytest.mark.slow
def test_plain_versions_match_the_pallas_kernels(graphs):
    """The JAX Pallas kernels (attn_fwd_planned, attn_bwd1_planned,
    attn_bwd2_planned) in interpret mode, forced onto the small graph as
    tests/test_attention.py forces them, against the port's plain
    versions: forward (out, m, s), pass 1 (sds, dvr) and the gradients."""
    import gala_tpu.ops.pallas.bell_spmm as pb

    _, tg, host = graphs
    from gala_tpu.data.csr import HostCSR as JHostCSR

    jhost = JHostCSR(**{k: getattr(host, k) for k in host.__dataclass_fields__})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pb, "_MIN_PLAN_SLOTS", 0)
        mp.setenv("GALA_PALLAS_REUSE_MIN", "0")
        mp.setattr(pb, "_MIN_R", 8)
        ab = JA.AttnBell.from_host(jhost, tg.n_pad, tg.c_pad, use_pallas=True)
        assert ab.fwd.pallas_plans[-1] is not None and ab.t.pallas_plans[-1] is not None
        for nh in HEADS:
            x, vl, vr, dout = _inputs(tg, nh, seed=10 + nh)
            out, vr_bin, m_bin, s_bin, m_node, s_node, flash = JA._attn_fwd_chunked(
                ab, x, vl, vr, SLOPE, tg.n_pad)
            assert flash is None  # the kernels do not emit the flash statistics
            tx, tvl, tvr, tdout = _t(x, vl, vr, dout)
            got = K.attn_fwd_reference(tg.attn.fwd, tx, tvl, tvr, SLOPE, tg.n_pad, False)
            for g, w in zip(got[:3], (out, m_node, s_node)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
            args = (ab, x, vl, vr, vr_bin, m_bin, s_bin, m_node, s_node, SLOPE, dout, tg.c_pad)
            dx, dvl, dvr = JA._attn_bwd_chunked(*args, flash=None)
            sds, a, b = K.attn_bwd1_reference(tg.attn.fwd, tx, tvl, tvr, tdout,
                                              *_t(np.asarray(m_node), np.asarray(s_node)), SLOPE)
            np.testing.assert_allclose((a - sds * b).numpy(), np.asarray(dvr), **TOL)
            for t in (tx, tvl, tvr):
                t.requires_grad_(True)
            o = TA.attention_aggregate(tg.n_pad, tg.c_pad, SLOPE, tg.attn, tx, tvl, tvr)
            (o * tdout).sum().backward()
            for t, w in zip((tx, tvl, tvr), (dx, dvl, dvr)):
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


def test_compare_with_plain_holds_the_flash_identity(graphs, oracle):
    """The card's check (attn_bell.compare_with_plain) on CPU tensors, where
    the wrappers run the plain versions: every kernel-vs-plain check is
    exact, and bwd1 must meet the flash identity within its tolerance."""
    _, tg, _ = graphs
    res = K.compare_with_plain(tg.attn, *_t(*oracle["inputs"]), SLOPE, tg.n_pad, tg.c_pad)
    assert {k: v for k, v in res.items() if v[1]} == {}
    assert all(v[0] == 0 for k, v in res.items() if "=" not in k)
    assert max(v[0] for k, v in res.items() if "=" in k) > 0


def test_cpu_calls_count_no_launches_and_counts_reset_together(graphs):
    """Each kernel has its own launch record; on CPU tensors the wrappers
    run the plain versions and record neither launches nor plain calls on
    the card; reset_counts zeroes every record."""
    from gala_tpu_torch.ops.kernels import _build, bell_spmm

    _, tg, _ = graphs
    x, vl, vr, dout = _t(*_inputs(tg, 1, seed=3))
    counts = _build.all_counts()
    assert {*K.NAMES, "bell_spmm"} <= counts.keys()
    assert counts["bell_spmm"] is bell_spmm.counts and counts["attn_fwd"] is K.counts["attn_fwd"]
    counts["attn_bwd2"].launches = 3
    _build.reset_counts()
    TA.attention_aggregate(tg.n_pad, tg.c_pad, SLOPE, tg.attn, x.requires_grad_(True), vl,
                           vr).sum().backward()
    assert all(c.launches == 0 and c.reference_calls_on_cuda == 0 for c in counts.values())
