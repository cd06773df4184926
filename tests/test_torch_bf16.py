"""bf16 activations with f32 params in gala_tpu_torch against gala_tpu's
dtype=jnp.bfloat16, on the CPU.

The same numpy inputs (seeded) and gala_tpu's weights copied over
(weights.params_from_jax); JAX runs its XLA executors and the port the
plain versions its kernel wrappers run for CPU tensors, which compute in
f32 from the bf16 values and round once, as the kernels do on the card.

Tolerances, and why:
- one op: |port - gala_tpu| <= 2^-7 * sum|terms| per output row (the
  row's largest sum of the magnitudes of the summed terms, taken in f32
  from the same bf16 values).  Both read the same bf16 values; gala_tpu
  rounds where the port does not (each hub virtual row's partial and the
  hub sum in bf16, the segment executor's products and every add in
  bf16, the attention probabilities before their product), and a bf16
  rounding errs by up to 2^-8 of the value rounded, so the two may differ
  by a bf16 unit of the row's larger sums (per element, gala_tpu's
  segment sums of 8 bf16 adds miss by up to 1.34 * 2^-7 here).
- one compiled program or hand model: forward within 4e-2 * max|gala_tpu's
  f32 logits| (two layers of bf16 activations, each FFN in bf16), and the
  port's bf16 logits no farther from gala_tpu's f32 logits (Frobenius
  norm) than twice gala_tpu's own bf16 logits are: the port is as good a
  bf16 run as gala_tpu's, not merely near it.
- 6 training epochs: losses within rtol 2e-3 (the loss is f32 on both
  sides; the logits under it are bf16).
Every output dtype equals gala_tpu's (GIN's logits are f32: its learned
epsilon is a 0-d f32 array, which promotes bf16 in JAX), and params,
their gradients and the optimizer state stay f32."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gala_tpu
import gala_tpu.ops.attention as JA
import gala_tpu.ops.edge as JE
import gala_tpu.train_minibatch as JM
import gala_tpu_torch
import gala_tpu_torch.ops.edge as TE
import gala_tpu_torch.train_minibatch as TM
from __graft_entry__ import GAT_DSL, GCN_DSL
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu.dsl.parser import parse_file as jparse_file
from gala_tpu.dsl.parser import parse_source as jparse_source
from gala_tpu.models import gat as jgat
from gala_tpu.models import gcn as jgcn
from gala_tpu.models import gin as jgin
from gala_tpu.models import sage as jsage
from gala_tpu.ops.spmm import spmm as jspmm
from gala_tpu.ops.spmm import spmm_ev as jspmm_ev
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.dsl.parser import parse_file, parse_source
from gala_tpu_torch.models import gat as tgat
from gala_tpu_torch.models import gcn as tgcn
from gala_tpu_torch.models import gin as tgin
from gala_tpu_torch.models import sage as tsage
from gala_tpu_torch.models.common import activation_dtype
from gala_tpu_torch.ops import spmm as TS
from gala_tpu_torch.ops.attention import attention_aggregate
from gala_tpu_torch.ops.graph import Graph as TGraph
from gala_tpu_torch.ops.kernels import attn_bell as K
from gala_tpu_torch.ops.kernels import bell_spmm as KB
from gala_tpu_torch.ops.kernels import sddmm as KS
from gala_tpu_torch.train import make_optimizer, masked_cross_entropy
from gala_tpu_torch.weights import params_from_jax, params_to_numpy
from tests.test_torch_attention import SLOPE, _graph_pair
from tests.test_torch_edge import graph_pair
from tests.test_torch_train import _data

torch.set_num_threads(2)

BF16 = torch.bfloat16
OP_RTOL = 2.0**-7
LOGIT_TOL = 4e-2
LOSS_RTOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GCN_SPARSER = GCN_DSL + "\nG = G.is_sparser(true);\n"


def _example(name):
    return os.path.join(REPO, "examples", f"{name}.txt")


def _bf16(seed, *shape, positive=False):
    """Seeded normal values, rounded to bf16 and held in f32 (exactly the
    values both sides read)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a = np.abs(a) if positive else a
    return torch.from_numpy(a).to(BF16).float().numpy()


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32)).to(BF16)


def _np(v):
    """A JAX or torch array as f32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _dtype_name(v):
    return str(v.dtype).removeprefix("torch.")


def _op_close(got, want, scale, what="", exact=None):
    """|got - want| <= 2^-7 * scale per output row (a row's largest sum of
    magnitudes; an element of a 1-D output is its own row), and the same
    dtype.  With `exact` (the f64 result), gala_tpu's own error
    |want - exact| is allowed on top: where gala_tpu adds in bf16 (its
    segment executor), a long row drifts by more than a unit."""
    assert _dtype_name(got) == _dtype_name(want), (what, got.dtype, want.dtype)
    err = np.abs(_np(got) - _np(want))
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 2:
        scale = scale.max(axis=1, keepdims=True)
    bound = OP_RTOL * scale + 1e-6
    if exact is not None:
        bound = bound + np.abs(_np(want) - np.asarray(exact, np.float32))
        assert (np.abs(_np(got) - exact) <= bound).all(), (what, "from the f64 result")
    assert (err <= bound).all(), (what, float((err - bound).max()))


def _rows(lay, x, n_out, vals=None):
    """The SpMM on a row-descriptor layout in f64 (exact for these inputs)."""
    return KB.bell_spmm_rows_reference(
        lay, torch.from_numpy(np.asarray(x, np.float64)), n_out,
        None if vals is None else lay.slot_values(torch.from_numpy(vals).double())).numpy()


# --------------------------------------------------------------------------- #
# single ops on the hub graph (an in-hub of 320 edges, an out-hub of 300,
# self-loops, isolated rows, weighted and directed)
# --------------------------------------------------------------------------- #
SPMM_STRATEGIES = ["dense", "bell", "ell", "segment"]


@pytest.fixture(scope="module", params=SPMM_STRATEGIES)
def pair(request):
    return graph_pair("hub_selfloops", request.param)


@pytest.mark.parametrize("f", [1, 33])
def test_spmm_and_dx_match_jax_at_bf16(pair, f):
    jg, tg = pair
    x = _bf16(10 + f, tg.c_pad, f)
    x[tg.n_cols:] = 0.0
    dz = _bf16(20 + f, tg.n_pad, f)
    out, vjp = jax.vjp(lambda u: jspmm(jg, u), _j(x))
    (jdx,) = vjp(_j(dz))
    xt = _t(x).requires_grad_(True)
    got = TS.spmm(tg, xt)
    got.backward(_t(dz))
    _op_close(got, out, _rows(tg.seg, np.abs(x), tg.n_pad), "out", exact=_rows(tg.seg, x, tg.n_pad))
    _op_close(xt.grad, jdx, _rows(tg.t_seg, np.abs(dz), tg.c_pad), "dx",
              exact=_rows(tg.t_seg, dz, tg.c_pad))


def test_spmm_ev_and_its_grads_match_jax_at_bf16(pair):
    """Learned bf16 edge values (the unfused GAT's softmax values) on every
    padded edge; devals is the SDDMM at bf16."""
    jg, tg = pair
    f = 33
    x = _bf16(30, tg.c_pad, f)
    vals = _bf16(40, tg.e_pad, positive=True)
    dz = _bf16(50, tg.n_pad, f)
    out, vjp = jax.vjp(lambda v, u: jspmm_ev(jg, v, u), _j(vals), _j(x))
    jdv, jdx = vjp(_j(dz))
    vt, xt = _t(vals).requires_grad_(True), _t(x).requires_grad_(True)
    got = TS.spmm_ev(tg, vt, xt)
    got.backward(_t(dz))
    ax, adz = (torch.from_numpy(np.abs(a)) for a in (x, dz))
    _op_close(got, out, _rows(tg.seg, np.abs(x), tg.n_pad, vals), "out",
              exact=_rows(tg.seg, x, tg.n_pad, vals))
    _op_close(xt.grad, jdx, _rows(tg.t_seg, np.abs(dz), tg.c_pad, vals), "dx",
              exact=_rows(tg.t_seg, dz, tg.c_pad, vals))
    _op_close(vt.grad, jdv, KS.sddmm_reference(tg.src, tg.dst, ax, adz).numpy(), "devals")


@pytest.mark.parametrize("op", ["sddvv_add", "sddvv_mul", "edge_softmax", "sddmm"])
def test_edge_ops_match_jax_at_bf16(op):
    """The edge ops and their gradients in bf16, as gala_tpu runs them:
    SDDVV's one sum or product per edge, the softmax's segment max and
    sums (scale: the probabilities themselves, which sum to 1 over a
    segment), the SDDMM's dot (scale sum_f |a||b|); and mask_padded_edges
    on each result."""
    jg, tg = graph_pair("hub_selfloops", "segment")
    if op == "edge_softmax":
        ins = [_bf16(1, tg.e_pad) * 3]
    elif op == "sddmm":
        ins = [_bf16(2, tg.c_pad, 7), _bf16(3, tg.n_pad, 7)]
    else:
        ins = [_bf16(4, tg.c_pad, 1), _bf16(5, tg.n_pad, 1)]
    cot = _bf16(6, tg.e_pad)
    out, vjp = jax.vjp(lambda *a: getattr(JE, op)(jg, *a), *map(_j, ins))
    want = [out, *vjp(_j(cot))]
    targs = [_t(a).requires_grad_(True) for a in ins]
    got = getattr(TE, op)(tg, *targs)
    got.backward(_t(cot))
    a = [torch.from_numpy(np.abs(v)) for v in ins]
    if op == "sddmm":
        scales = [KS.sddmm_reference(tg.src, tg.dst, *a).numpy(),
                  _edge_scatter(tg.src, np.abs(cot)[:, None] * np.abs(ins[1])[tg.dst], tg.c_pad),
                  _edge_scatter(tg.dst, np.abs(cot)[:, None] * np.abs(ins[0])[tg.src], tg.n_pad)]
    elif op == "edge_softmax":
        p = np.abs(_np(out))
        sums = _edge_scatter(tg.dst, p * np.abs(cot), tg.n_pad)
        scales = [p + 1e-2, p * (np.abs(cot) + sums[tg.dst.numpy()]) + 1e-2]
    else:
        e = np.abs(_np(out))[:, None]
        scales = [e, _edge_scatter(tg.src, np.abs(cot) * _edge_other(op, ins, tg, 1), tg.c_pad),
                  _edge_scatter(tg.dst, np.abs(cot) * _edge_other(op, ins, tg, 0), tg.n_pad)]
    for g, w, sc in zip([got, *(t.grad for t in targs)], want, scales):
        _op_close(g, w, np.asarray(sc).reshape(np.shape(_np(w))), op)
    # the padding edges' entries zeroed in the input dtype, as gala_tpu's
    masked, jmasked = TE.mask_padded_edges(tg, got.detach()), JE.mask_padded_edges(jg, out)
    assert _dtype_name(masked) == _dtype_name(jmasked)
    assert not masked[tg.n_edges:].any() and torch.equal(masked[: tg.n_edges],
                                                          got.detach()[: tg.n_edges])


def _edge_scatter(idx, v, n):
    """sum of v's edge rows into n rows by idx."""
    v = np.asarray(v, np.float32)
    out = np.zeros((n,) + v.shape[1:], np.float32)
    np.add.at(out, np.asarray(idx), v)
    return out


def _edge_other(op, ins, tg, side):
    """The factor an SDDVV edge's gradient w.r.t. one side carries: 1 for
    the sum, the other side's value for the product."""
    if op == "sddvv_add":
        return np.ones(tg.e_pad, np.float32)
    idx = tg.src if side == 0 else tg.dst
    return np.abs(ins[side][idx.numpy(), 0])


@pytest.mark.parametrize("nh", [1, 4])
def test_attention_aggregate_matches_jax_at_bf16(nh):
    """The fused op's forward and its three gradients at bf16 (x, vl, vr
    bf16; gala_tpu's flash-identity backward on its XLA executors)."""
    jg, tg, _ = _graph_pair()
    hf = 16
    x, vl, vr, dout = (_bf16(nh * 10 + i, *shape) for i, shape in enumerate(
        ((tg.c_pad, hf), (tg.c_pad, nh), (tg.n_pad, nh), (tg.n_pad, hf))))

    def loss(*a):
        o = JA.attention_aggregate(jg.n_pad, jg.c_pad, SLOPE, jg.attn, *a)
        return jnp.sum(o.astype(jnp.float32) * dout), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        _j(x), _j(vl), _j(vr))
    ts = [_t(a).requires_grad_(True) for a in (x, vl, vr)]
    out = attention_aggregate(tg.n_pad, tg.c_pad, SLOPE, tg.attn, *ts)
    (out.float() * torch.from_numpy(dout)).sum().backward()
    scales = K.aggregate_scales(tg.attn, *(torch.from_numpy(a) for a in (x, vl, vr, dout)),
                                SLOPE, tg.n_pad, tg.c_pad)
    for name, got, want, sc in zip(("out", "dx", "dvl", "dvr"), [out] + [t.grad for t in ts],
                                   [jout, *jgrads], scales):
        _op_close(got, want, sc.numpy(), name)


# --------------------------------------------------------------------------- #
# compiled programs: every program the port compiles, at bf16
# --------------------------------------------------------------------------- #
PROGRAMS = {
    "gcn": (GCN_DSL, "bell"),
    "gcn_dense": (GCN_DSL, "dense"),
    "gat": (GAT_DSL, "bell"),
    "gat_heads": ("gat.txt", "bell"),
    "gat_unfused": (GAT_DSL, "ell"),
    "gcn_sparser": (GCN_SPARSER, "ell"),
    "sage": ("sage.txt", "bell"),
    "gin": ("gin.txt", "bell"),
    "gcn_dynamic": (GCN_DSL + "aggrFn=aggrFn.sample(20).dynamic();\n", "bell"),
}


def _specs(name):
    src, _ = PROGRAMS[name]
    if src.endswith(".txt"):
        jspec, tspec = jparse_file(_example(src[:-4])), parse_file(_example(src[:-4]))
    else:
        jspec, tspec = jparse_source(src), parse_source(src)
    if name == "gat_unfused":
        jspec.passes.attention_fusion = tspec.passes.attention_fusion = False
    return jspec, tspec


@pytest.fixture(scope="module", params=list(PROGRAMS))
def program(request):
    """gala_tpu's program at bf16 and at f32, the port's at bf16, gala_tpu's
    initial weights, and each side's logits from them on the full graph."""
    name = request.param
    strategy = PROGRAMS[name][1]
    kw = dict(mode="train", strategy=strategy)
    jcm = gala_tpu.compile_model(_specs(name)[0], data=_data(jax_dataset), dtype=jnp.bfloat16,
                                 **kw)
    jcm32 = gala_tpu.compile_model(_specs(name)[0], data=_data(jax_dataset), **kw)
    tcm = gala_tpu_torch.compile_model(_specs(name)[1], data=_data(torch_dataset), dtype=BF16,
                                       device="cpu", **kw)
    jparams = jax.device_get(jcm.make_params(0))

    def jlogits(cm):
        gs = cm.full_graphs
        return jax.jit(cm.forward)(jparams, gs, jax.jit(cm.invariant)(gs, cm.x))

    with torch.no_grad():
        gs = tcm.full_graphs
        tlogits = tcm.forward(params_from_jax(jparams), gs, tcm.invariant(gs, tcm.x))
    return dict(name=name, jcm=jcm, tcm=tcm, jparams=jparams, j16=jlogits(jcm),
                j32=jlogits(jcm32), t16=tlogits)


def test_bf16_program_builds_what_gala_tpu_builds(program):
    jcm, tcm = program["jcm"], program["tcm"]
    assert tcm.full_graphs[0].strategy == jcm.full_graphs[0].strategy == PROGRAMS[
        program["name"]][1]
    assert [n.op.name for n in tcm.program.all_nodes()] == [
        n.op.name for n in jcm.program.all_nodes()]
    assert tcm.x.dtype == BF16 and jcm.x.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(tcm.x), _np(jcm.x))
    with torch.no_grad():
        tcarry = tcm.invariant(tcm.full_graphs, tcm.x)
    jcarry = jax.jit(jcm.invariant)(jcm.full_graphs, jcm.x)
    for (_, t), (_, j) in zip(sorted(tcarry.items()), sorted(jcarry.items())):
        assert _dtype_name(t) == _dtype_name(j)


def test_bf16_forward_matches_jax(program):
    """Logits within 4e-2 * max|f32 logits| of gala_tpu's bf16 logits, in
    gala_tpu's dtype (f32 for GIN, bf16 for the others)."""
    t16, j16, j32 = program["t16"], program["j16"], program["j32"]
    assert _dtype_name(t16) == _dtype_name(j16)
    assert (t16.dtype == torch.float32) == (program["name"] == "gin")
    tol = LOGIT_TOL * float(np.abs(_np(j32)).max())
    np.testing.assert_allclose(_np(t16), _np(j16), rtol=0, atol=tol)


def test_bf16_forward_is_as_close_to_f32_as_gala_tpus(program):
    t16, j16, j32 = (_np(program[k]) for k in ("t16", "j16", "j32"))
    assert np.linalg.norm(t16 - j32) <= 2 * np.linalg.norm(j16 - j32)


def test_bf16_training_matches_jax(program):
    """6 epochs (valid_step 5) from gala_tpu's weights: losses within rtol
    2e-3; the final params f32."""
    jcm, tcm = program["jcm"], program["tcm"]
    jres = jcm.train(iters=6, warmup=1)
    tres = tcm.train(iters=6, warmup=1, params=params_from_jax(program["jparams"]))
    assert len(tres.losses) == len(jres.losses) == 6
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tres.params.parameters())
    assert all(np.asarray(v).dtype == np.float32
               for v in jax.tree_util.tree_leaves(jax.device_get(jres.params)))


def test_bf16_gradients_and_optimizer_state_stay_f32(program):
    """One training step's gradients reach every f32 parameter in f32
    through the FFNs' casts, and Adam's moments are f32."""
    tcm = program["tcm"]
    params = params_from_jax(program["jparams"])
    opt = make_optimizer(params)
    gs = tcm.full_graphs
    with torch.no_grad():
        carry = tcm.invariant(gs, tcm.x)
    masked_cross_entropy(tcm.forward(params, gs, carry), tcm.labels, tcm.train_mask).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in params.parameters())
    opt.step()
    state = [v for s in opt.state.values() for v in s.values() if isinstance(v, torch.Tensor)]
    assert state and all(v.dtype == torch.float32 for v in state if v.dim())


# --------------------------------------------------------------------------- #
# hand models
# --------------------------------------------------------------------------- #
HAND = {"gcn": (jgcn, tgcn, {}), "gat": (jgat, tgat, {}), "gat_heads": (jgat, tgat, {"n_heads": 2}),
        "sage": (jsage, tsage, {}), "gin": (jgin, tgin, {})}


@pytest.mark.parametrize("model", list(HAND))
def test_hand_model_at_bf16_matches_jax(model):
    """The hand models on 'bell' (GAT with its fused layout) at bf16: dtype,
    forward and the f32-closeness of gala_tpu's; gradients f32."""
    jmod, tmod, kw = HAND[model]
    jd, td = _data(jax_dataset), _data(torch_dataset)
    att = model.startswith("gat")
    jg = gala_tpu.ops.graph.Graph.from_host(jd[0], strategy="bell", attention=att)
    tg = TGraph.from_host(td[0], strategy="bell", attention=att, device="cpu")
    jparams = jax.device_get(jmod.init(jax.random.key(0), 24, [8], 5, **kw))
    if model == "gin":  # away from 0, so (1 + eps) is not the identity
        jparams["eps"] = [np.float32(0.3), np.float32(-0.2)]
    x = np.asarray(jg.pad_nodes(jd[1]))
    fwd = jax.jit(lambda p, v: jmod.forward(p, [jg, jg], v, **kw))
    j16, j32 = fwd(jparams, _j(x)), fwd(jparams, jnp.asarray(x))
    params = params_from_jax(jparams)
    t16 = tmod.forward(params, [tg, tg], _t(x), **kw)
    assert _dtype_name(t16) == _dtype_name(j16)
    np.testing.assert_allclose(_np(t16), _np(j16), rtol=0,
                               atol=LOGIT_TOL * float(np.abs(_np(j32)).max()))
    assert np.linalg.norm(_np(t16) - _np(j32)) <= 2 * np.linalg.norm(_np(j16) - _np(j32))
    t16.float().square().sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in params.parameters())


# --------------------------------------------------------------------------- #
# minibatch SAGE and the dtype argument
# --------------------------------------------------------------------------- #
def test_minibatch_training_matches_jax_at_bf16(monkeypatch):
    """3 epochs of train_sage_minibatch at bf16 (the feature table bf16,
    the gathers and means at bf16, the batch loss f32) from gala_tpu's
    initial weights: per-epoch losses within rtol 2e-3; params f32."""
    from gala_tpu_torch.models import sage

    kw = dict(fanouts=(5, 3), batch_size=64, hidden=16, iters=3, valid_step=1, warmup=1, seed=0)
    mb = dict(n=600, avg_degree=8, n_feats=16, n_classes=5, seed=0)
    jres = JM.train_sage_minibatch(*jax_dataset(**mb), dtype=jnp.bfloat16, **kw)
    jparams = jax.device_get(jsage.init(jax.random.key(0), 16, [16], 5))
    monkeypatch.setattr(sage, "init", lambda *a, **k: params_from_jax(jparams))
    tres = TM.train_sage_minibatch(*torch_dataset(**mb), dtype=BF16, device="cpu", **kw)
    assert len(tres.losses) == len(jres.losses) == 3
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=LOSS_RTOL)
    assert tres.losses[-1] < tres.losses[0]
    assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(
        params_to_numpy(tres.params)))


@pytest.mark.parametrize("dtype,want", [(None, None), (torch.float32, torch.float32),
                                        (BF16, BF16), ("bfloat16", BF16), ("float32", torch.float32),
                                        (np.float32, torch.float32)])
def test_activation_dtype_names(dtype, want):
    assert activation_dtype(dtype) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, "int8"])
def test_other_activation_dtypes_are_refused(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gala_tpu_torch.compile_source(GCN_DSL, data=_data(torch_dataset), dtype=dtype,
                                      device="cpu")
