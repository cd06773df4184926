"""The GAT paper's multi-head model through the DSL: `gat_heads(H, out=K)`
and `dsl.non_ln.ELU`.

Parsed, compiled to per-head scores (attenL/RWeight{i} of shape (F', H)),
the fused attention at H heads, ELU and the output heads' mean; held to
the hand-written GAT (models/gat.py, already of this form) on 'bell' and
'dense' (gala_bench/tests/test_bench_heads.py holds it to the benchmark's
plain reference of the configuration).  Programs without the new
statements compile as before.
"""
import json
import os

import pytest
import torch

import gala_tpu_torch
from __graft_entry__ import GCN_DSL
from gala_bench import graphgen
from gala_tpu_torch.dsl import parser
from gala_tpu_torch.dsl.parser import DSLSyntaxError
from gala_tpu_torch.dsl.spec import ModelSpec
from gala_tpu_torch.ir.build import generate_ir
from gala_tpu_torch.lowering import heads as gat_heads
from gala_tpu_torch.lowering.heads import parse_source
from gala_tpu_torch.models import gat
from gala_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(REPO, "gala_bench", "configs", "gat2-h8x8.json")))
DSL = CONFIG["dsl"]
# 600 nodes, 16 features, 5 classes, 4,850 nonzeros: R-MAT as the benchmark makes it
SMALL = {"name": "small", "nodes": 600, "features": 16, "classes": 5, "draws": 3000,
         "nonzeros_target": 4850, "graph_seed": 11,
         "split": {"train": 300, "val": 100, "test": 200}}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    return graphgen.make_graph(SMALL, "cpu")


def _dsl(heads="gat_heads(8, out=8);", act="ELU", hidden=8):
    return (DSL.replace("gat_heads(8, out=8);", heads)
            .replace("dsl.non_ln.ELU", f"dsl.non_ln.{act}")
            .replace("L1(G, 8,", f"L1(G, {hidden},"))


def _compile(small, dsl=DSL, strategy="bell"):
    return gala_tpu_torch.compile_source(dsl, mode="train", data=graphgen.host_data(small),
                                         device="cpu", strategy=strategy)


# ---------------------------------------------------------------------- #
# parse
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("stmt,heads,out", [("gat_heads(8, out=8);", 8, 8),
                                            ("gat_heads(4);", 4, 1),
                                            ("gat_heads( 2 , out = 3 );", 2, 3),
                                            ("", 0, 1)])
def test_gat_heads_statement_parses(stmt, heads, out):
    spec = parse_source(_dsl(heads=stmt))
    assert (spec.gat_heads, spec.gat_out_heads) == (heads, out)
    assert spec.attention_heads == 1
    assert [spec.heads_of(li) for li in range(spec.num_layers)] == (
        [heads, out] if heads else [1, 1])


@pytest.mark.parametrize("act,want", [("ELU", "elu"), ("ReLU", "relu")])
def test_model_init_nonlinearity_parses(act, want):
    spec = parse_source(_dsl(act=act))
    assert spec.nonlinearity == want
    assert spec.nonln_present == [True, False]


@pytest.mark.parametrize("stmt", ["gat_heads(0);", "gat_heads(4, out=0);"])
def test_gat_heads_refuses_no_heads(stmt):
    with pytest.raises(DSLSyntaxError, match="H >= 1 heads and out=K >= 1"):
        parse_source(_dsl(heads=stmt))


# ---------------------------------------------------------------------- #
# compile
# ---------------------------------------------------------------------- #
def test_compiled_parameters_are_per_head(small):
    cm = _compile(small)
    got = {k: tuple(v.shape) for k, v in cm.make_params(0).named_parameters()}
    f, c = small.feats.shape[1], small.n_classes
    assert got == {
        "weight1.w": (f, 64), "weight1.b": (64,),
        "attenLWeight1.w": (8, 8), "attenLWeight1.b": (8,),
        "attenRWeight1.w": (8, 8), "attenRWeight1.b": (8,),
        "weight2.w": (64, 8 * c), "weight2.b": (8 * c,),
        "attenLWeight2.w": (c, 8), "attenLWeight2.b": (8,),
        "attenRWeight2.w": (c, 8), "attenRWeight2.b": (8,),
    }
    ops = [(n.op.name, n.params) for n in cm.program.loop.nodes]
    assert ops == [("FFN", []), ("FFN_EDGE", ["8"]), ("FFN_EDGE", ["8"]),
                   ("FUSED_ATTENTION", ["0.2"]), ("TRANSFORM", ["elu", "8"]),
                   ("FFN", []), ("FFN_EDGE", ["8"]), ("FFN_EDGE", ["8"]),
                   ("FUSED_ATTENTION", ["0.2"]), ("TRANSFORM", ["head_mean", "8"])]
    fused = [n for n in cm.program.loop.nodes if n.op.name == "FUSED_ATTENTION"]
    assert [(n.inputs[0].cols, n.inputs[1].cols) for n in fused] == [(64, 8), (8 * c, 8)]
    assert cm.program.loop.nodes[-1].outputs[0].cols == c


def test_scores_and_head_mean_are_the_per_head_forms(small):
    """One forward of the compiled program, by hand: head h scores from its
    own columns, the output is the mean of the heads' aggregations."""
    from gala_tpu_torch.ops.attention import attention_aggregate

    cm = _compile(small)
    p = cm.make_params(3)
    g = cm.full_graphs[0]
    with torch.no_grad():
        got = cm.forward(p, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
        h = cm.x
        for i, nh in ((1, 8), (2, 8)):
            z = h @ p[f"weight{i}"]["w"] + p[f"weight{i}"]["b"]
            fh = z.shape[1] // nh
            zs = z.view(z.shape[0], nh, fh)
            vl = torch.einsum("nhf,fh->nh", zs, p[f"attenLWeight{i}"]["w"]) + p[f"attenLWeight{i}"]["b"]
            vr = torch.einsum("nhf,fh->nh", zs, p[f"attenRWeight{i}"]["w"]) + p[f"attenRWeight{i}"]["b"]
            out = attention_aggregate(g.n_pad, g.c_pad, 0.2, g.attn, z, vl, vr)
            h = torch.nn.functional.elu(out) if i == 1 else out.view(-1, nh, fh).mean(1)
    torch.testing.assert_close(got, h, **TOL)


def _to_models_gat(cp) -> torch.nn.ModuleDict:
    """The compiled parameters in models/gat.py's layout (attention vectors
    (H, F'), the transpose of the compiled (F', H))."""
    def vec(p):
        return torch.nn.ParameterDict({"w": torch.nn.Parameter(p["w"].detach().t().clone()),
                                       "b": torch.nn.Parameter(p["b"].detach().clone())})

    def fc(p):
        return torch.nn.ParameterDict({k: torch.nn.Parameter(v.detach().clone())
                                       for k, v in p.items()})

    return torch.nn.ModuleDict({
        "fc": torch.nn.ModuleList([fc(cp["weight1"]), fc(cp["weight2"])]),
        "attn_l": torch.nn.ModuleList([vec(cp["attenLWeight1"]), vec(cp["attenLWeight2"])]),
        "attn_r": torch.nn.ModuleList([vec(cp["attenRWeight1"]), vec(cp["attenRWeight2"])]),
    })


@pytest.mark.parametrize("strategy", ["bell", "dense"])
@pytest.mark.parametrize("heads", [4, 8])
def test_program_matches_models_gat(small, strategy, heads):
    """gat_heads(H, out=H) with ReLU is models/gat.py's multi-head GAT
    (H heads of 8, concatenated, ReLU; H output heads averaged): logits
    and every gradient on the same weights."""
    cm = _compile(small, _dsl(heads=f"gat_heads({heads}, out={heads});", act="ReLU"),
                  strategy)
    assert cm.full_graphs[0].strategy == strategy
    cp = cm.make_params(1)
    mp = _to_models_gat(cp)
    carry = cm.invariant(cm.full_graphs, cm.x)
    got = cm.forward(cp, cm.full_graphs, carry)
    want = gat.forward(mp, cm.full_graphs, cm.x, 0.2, n_heads=heads)
    torch.testing.assert_close(got, want, **TOL)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(2))
    (got * dy).sum().backward()
    (want * dy).sum().backward()
    for i in (1, 2):
        torch.testing.assert_close(cp[f"weight{i}"]["w"].grad, mp["fc"][i - 1]["w"].grad, **TOL)
        for side, key in (("L", "attn_l"), ("R", "attn_r")):
            torch.testing.assert_close(cp[f"atten{side}Weight{i}"]["w"].grad,
                                       mp[key][i - 1]["w"].grad.t(), **TOL)
            torch.testing.assert_close(cp[f"atten{side}Weight{i}"]["b"].grad,
                                       mp[key][i - 1]["b"].grad, **TOL)


def test_new_ops_are_spans_with_their_counts(small, tmp_path):
    """Under a profiler the per-head scores, the head mean and ELU are the
    spans `gala.head_scores`, `gala.head_mean` and `gala.elu` of the
    trace, which the benchmark's head_ops_ms reads: each forward (the
    step's, the inference epoch's, the test evaluation's) scores twice a
    layer, applies ELU once and averages once, so k forwards give 4k
    score spans, k mean spans and k ELU spans.  They count no work."""
    cm = _compile(small)
    with profiling.profile_trace(str(tmp_path)):
        cm.train(iters=1)
    trace = [f for f in os.listdir(tmp_path) if f.endswith(".json") and "counts" not in f]
    events = json.load(open(tmp_path / trace[0]))["traceEvents"]
    spans = {name: sum(e.get("name") == name and e.get("ph") == "X" for e in events)
             for name in ("gala.head_scores", "gala.head_mean", "gala.elu", "gala.attention")}
    k = spans["gala.elu"]
    assert k >= 2 and spans["gala.attention"] >= 2 * k
    assert spans["gala.head_scores"] == 4 * k and spans["gala.head_mean"] == k
    names = {r["name"] for r in profiling.counts()}
    assert "gala.attention" in names
    assert not names & {"gala.head_scores", "gala.head_mean", "gala.elu"}


# ---------------------------------------------------------------------- #
# the output layer's mean folded into its attention
# ---------------------------------------------------------------------- #
def _step(cm, seed=1):
    """(loss, {parameter: gradient}) of one training step's loss (the
    train rows' masked cross entropy on the full graph, as train takes it)
    from the parameters of `seed`."""
    from gala_tpu_torch.train import masked_cross_entropy

    p = cm.make_params(seed)
    rows = torch.nonzero(cm.train_mask).flatten()
    logits = cm.forward_rows(p, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x), rows)
    loss = masked_cross_entropy(logits, cm.labels[rows], cm.train_mask[rows])
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in p.named_parameters()}


@pytest.mark.parametrize("heads,strategy,folds", [("gat_heads(8, out=8);", "bell", 1),
                                                  ("gat_heads(8, out=1);", "bell", 0),
                                                  ("gat_heads(8);", "bell", 0),
                                                  ("gat_heads(8, out=8);", "dense", 0)])
def test_mean_folds_into_the_attention_only_over_averaged_heads_on_its_kernels(
        small, monkeypatch, heads, strategy, folds):
    """The output layer's attention and the head_mean after it run as one
    op (library.attention_mean) where the IR has the mean (out=8) and the
    attention kernels run ('bell'), not without averaged heads or on
    'dense' (head by head, then the mean).  Folded, the output layer's
    gradient is counted with dout_heads 1 and bwd2's table holds one dout
    block, pitch(5) + 4 * 8 = 40 floats a row; the hidden layer's 8 heads
    keep theirs, 8 * 8 + 32 = 96 (one output head: 8 + 4)."""
    from gala_tpu_torch.lowering import interp
    from gala_tpu_torch.ops.kernels import attn_bell, library

    calls, tables = [], []
    mean, plain = library.attention_mean, attn_bell.attn_bwd2_reference
    monkeypatch.setattr(library, "attention_mean",
                        lambda *a, **k: calls.append(1) or mean(*a, **k))
    monkeypatch.setattr(attn_bell, "attn_bwd2_reference",
                        lambda *a: tables.append(a[3].shape[1]) or plain(*a))
    cm = _compile(small, _dsl(heads=heads), strategy)
    assert len(interp.mean_folds(cm.program.loop.nodes)) == (heads.count("out=8") == 1)
    with torch.profiler.profile():
        profiling.clear_counts()
        _step(cm)
        grads = [r for r in profiling.counts() if r["name"] == "gala.attention.grad"]
    assert len(calls) == folds
    if strategy == "dense":
        assert tables == [] and grads == []
        return
    assert [(r["heads"], r["dout_heads"]) for r in grads] == [(8, 1) if folds else (1, 1),
                                                              (8, 8)]
    assert tables == ([40, 96] if folds else [8 + 4, 96])


def test_spmd_branch_keeps_the_separate_mean(small, monkeypatch):
    """On a rank's graph (strategy 'spmd') the attention and the mean stay
    two ops: the sharded attention's out, then head_mean of it."""
    from types import SimpleNamespace

    from gala_tpu_torch.lowering import interp
    from gala_tpu_torch.parallel import ops as pops

    cm = _compile(small)
    nodes = cm.program.loop.nodes
    (att_id, mean), = interp.mean_folds(nodes).items()
    att = next(n for n in nodes if id(n) == att_id)
    n, c = 7, small.n_classes
    sharded = torch.randn(n, 8 * c)
    monkeypatch.setattr(pops, "spmd_attention", lambda g, x, vl, vr, slope: sharded)
    monkeypatch.setattr(interp, "attention_aggregate",
                        lambda *a, **k: pytest.fail("the kernels' op on a rank's graph"))
    g = SimpleNamespace(strategy="spmd", n_pad=n, device="cpu")
    env = {d.uid: torch.randn(n, d.cols) for d in att.inputs if not d.is_graph}
    got = interp._eval_node(att, env, {}, [g, g], mean)
    assert torch.equal(got, sharded.view(n, 8, c).mean(dim=1))


@pytest.mark.parametrize("heads", ["gat_heads(8, out=8);", "gat_heads(4, out=4);"])
def test_folded_mean_gives_the_unfolded_loss_and_gradients_bitwise(small, monkeypatch, heads):
    """The folded program against the same program with the fold turned
    off (attention, then head_mean; autograd repeats the mean's dout / H
    for each head): step 1's loss and every gradient bit for bit, as the
    shared dout block holds the same values, summed in the same order."""
    from gala_tpu_torch.lowering import interp

    folded = _step(_compile(small, _dsl(heads=heads)))
    monkeypatch.setattr(interp, "mean_folds", lambda nodes: {})
    unfolded = _step(_compile(small, _dsl(heads=heads)))
    assert torch.equal(folded[0], unfolded[0])
    assert folded[1].keys() == unfolded[1].keys()
    for k, grad in folded[1].items():
        assert torch.equal(grad, unfolded[1][k]), k


@pytest.mark.parametrize("units", [False, True], ids=["plain", "units"])
@pytest.mark.parametrize("fh", [5, 8, 41])
def test_plain_bwd2_on_the_shared_table_equals_the_per_head_table(small, units, fh):
    """A mean's dout / H as one block (bwd2_table's shared form, pitch +
    4H wide) and repeated for each head (H * pitch + 4H): per_head_dot,
    and bwd2's plain version and units emulation, bit for bit."""
    from gala_tpu_torch.ops.kernels import attn_bell as KA

    g = _compile(small).full_graphs[0]
    nh, gen = 8, torch.Generator().manual_seed(fh)
    rand = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    x, vl, vr = rand(g.c_pad, nh * fh), rand(g.c_pad, nh), rand(g.n_pad, nh)
    out = rand(g.n_pad, nh * fh)
    m, s = rand(g.n_pad, nh), torch.rand((g.n_pad, nh), generator=gen) + 0.5
    dmean = rand(g.n_pad, fh)
    one = dmean / nh
    each = one.repeat(1, nh)
    sds = KA.per_head_dot(one, out, nh)
    assert torch.equal(sds, KA.per_head_dot(each, out, nh))
    shared, per_head = KA.bwd2_table(x, one, vr, m, s, sds), KA.bwd2_table(x, each, vr, m, s, sds)
    pitch = KA.row_pitch(fh)
    assert (shared.shape[1], per_head.shape[1]) == (pitch + 4 * nh, nh * pitch + 4 * nh)
    assert KA.shared_table(x, vl, shared) and not KA.shared_table(x, vl, per_head)
    if units:
        got = KA.attn_bwd2_units_reference(g.attn.t, x, vl, shared, 0.2, g.c_pad, True)
        want = KA.attn_bwd2_units_reference(g.attn.t, x, vl, per_head, 0.2, g.c_pad)
    else:
        got = KA.attn_bwd2(g.attn.t, x, vl, shared, 0.2, g.c_pad)
        want = KA.attn_bwd2(g.attn.t, x, vl, per_head, 0.2, g.c_pad)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------- #
# what the form refuses
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case,match", [
    ("nine_heads", "1 to 8 heads"),
    ("nine_out_heads", "1 to 8 heads"),
    ("segment", "runs on strategies"),
    ("ell", "runs on strategies"),
    ("unfused", "requires the fused attention path"),
    ("with_attention_heads", "two forms of heads"),
    ("gcn_body", "applies to a GAT layer body"),
])
def test_gat_heads_guards(small, case, match):
    strategy = {"segment": "segment", "ell": "ell"}.get(case, "bell")
    dsl = {"nine_heads": _dsl(heads="gat_heads(9, out=8);"),
           "nine_out_heads": _dsl(heads="gat_heads(8, out=9);"),
           "with_attention_heads": DSL + "attention_heads(4);",
           "gcn_body": GCN_DSL + "gat_heads(4);"}.get(case, DSL)
    spec = parse_source(dsl)
    if case == "unfused":
        spec.passes.attention_fusion = False
    with pytest.raises(ValueError, match=match):
        gala_tpu_torch.compile_model(spec, mode="train", data=graphgen.host_data(small),
                                     strategy=strategy, device="cpu")


def test_gat_heads_needs_the_widths_known():
    """Without a bound dataset the class count is symbolic, and H of them
    is no width."""
    spec = parse_source(DSL)
    with pytest.raises(ValueError, match="width of layer 1 known"):
        gat_heads.rewrite(generate_ir(spec), spec)
    spec = parse_source(_dsl(heads="gat_heads(8, out=1);"))
    assert gat_heads.rewrite(generate_ir(spec), spec).loop.nodes


def test_gat_heads_programs_stay_on_one_chip(small):
    from gala_tpu_torch.parallel.compiled import shard_compiled

    with pytest.raises(NotImplementedError, match="single-chip"):
        shard_compiled(_compile(small))


# ---------------------------------------------------------------------- #
# programs without the new statements
# ---------------------------------------------------------------------- #
def test_attention_heads_example_compiles_as_before(small):
    """examples/gat.txt (attention_heads(4)): dense (32, 4) scores in the
    hidden layer, one head in the last, ReLU; the IR and the parameters
    as before gat_heads existed."""
    path = os.path.join(REPO, "examples", "gat.txt")
    spec = gat_heads.parse_file(path)
    assert type(spec) is ModelSpec and spec == parser.parse_file(path)
    assert spec.attention_heads == 4
    cm = gala_tpu_torch.compile_file(path, mode="train", data=graphgen.host_data(small),
                                     strategy="bell", device="cpu")
    f, c = small.feats.shape[1], small.n_classes
    ir = [(n.op.name, [(d.name, d.cols) for d in n.inputs if not d.is_graph],
           [(d.name, d.cols) for d in n.outputs], n.params, n.layer)
          for n in cm.program.all_nodes() if n.op.name != "LOAD"]
    assert ir == [
        ("FFN", [("t_iden", f), ("weight1", 32)], [("res", 32)], [], 0),
        ("FFN_EDGE", [("res", 32), ("attenLWeight1", 4)], [("attenL", 4)], [], 0),
        ("FFN_EDGE", [("res", 32), ("attenRWeight1", 4)], [("attenR", 4)], [], 0),
        ("FUSED_ATTENTION", [("res", 32), ("attenL", 4), ("attenR", 4)], [("res", 32)],
         ["0.2"], 0),
        ("RELU", [("res", 32)], [("res", 32)], [], -1),
        ("FFN", [("res", 32), ("weight2", c)], [("res", c)], [], 1),
        ("FFN_EDGE", [("res", c), ("attenLWeight2", 1)], [("attenL_2", 1)], [], 1),
        ("FFN_EDGE", [("res", c), ("attenRWeight2", 1)], [("attenR_2", 1)], [], 1),
        ("FUSED_ATTENTION", [("res", c), ("attenL_2", 1), ("attenR_2", 1)], [("res", c)],
         ["0.2"], 1),
    ]
    got = {k: tuple(v.shape) for k, v in cm.make_params(0).named_parameters()}
    assert got == {"weight1.w": (f, 32), "weight1.b": (32,),
                   "attenLWeight1.w": (32, 4), "attenLWeight1.b": (4,),
                   "attenRWeight1.w": (32, 4), "attenRWeight1.b": (4,),
                   "weight2.w": (32, c), "weight2.b": (c,),
                   "attenLWeight2.w": (c, 1), "attenLWeight2.b": (1,),
                   "attenRWeight2.w": (c, 1), "attenRWeight2.b": (1,)}
