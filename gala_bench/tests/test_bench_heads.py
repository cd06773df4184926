"""The multi-head cell gat2-h8x8.reddit: its reference against the port on
the CPU, the heads-aware work counted by hand, and its two readers."""
import copy
import json
import os
import types

import pytest
import torch

import gala_tpu_torch
from gala_bench import cell as cells
from gala_bench import graphgen, heads_work, reference, spans, work

CELL = "gat2-h8x8.reddit"
EPOCHS = 6  # epochs 0 and 5 on the full graph, 1-4 on the subgraphs


@pytest.mark.parametrize("strategy", ["bell", "dense"])
def test_heads_reference_follows_the_port(small_cell, strategy):
    c = small_cell(CELL)
    g = graphgen.make_graph(c.traffic, "cpu")
    cm = gala_tpu_torch.compile_source(c.config["dsl"], mode="train",
                                       data=graphgen.host_data(g), device="cpu",
                                       strategy=strategy)
    weights = reference.init_weights(
        c.model.shapes(g.feats.shape[1], c.config["hidden"], g.n_classes), 9, "cpu")
    params = cells.program_params(cm, weights)
    assert tuple(params["attenLWeight2"]["w"].shape) == (g.n_classes, c.config["out_heads"])
    res = cm.train(iters=EPOCHS, params=copy.deepcopy(params))
    rg = reference.RefGraph.from_edges(g.row, g.col, g.n)
    loop = {k: c.config[k] for k in ("lr", "weight_decay", "valid_step")}
    ref = reference.follow(c.model, rg, g.feats, g.labels, g.masks["train"], weights, loop,
                           EPOCHS)
    assert res.losses == pytest.approx(ref.losses, rel=2e-6)
    got = dict(res.params.named_parameters())
    for k, want in ref.params.items():
        torch.testing.assert_close(got[k].detach(), want, rtol=0, atol=2e-6)


def test_config_matches_the_shapes_it_declares():
    c = cells.find_cell(CELL)
    assert (c.config["heads"], c.config["out_heads"], c.config["hidden"]) == (
        c.model.HEADS, c.model.OUT_HEADS, 8)
    assert "gat_heads(8, out=8);" in c.config["dsl"] and "dsl.non_ln.ELU" in c.config["dsl"]
    assert c.model.shapes(602, 8, 41) == [
        ("weight1", 602, 64), ("attenLWeight1", 8, 8), ("attenRWeight1", 8, 8),
        ("weight2", 64, 328), ("attenLWeight2", 41, 8), ("attenRWeight2", 41, 8)]


def test_heads_work_by_hand():
    """3 nodes, self loops and the edge 0 -> 1 both ways: 5 nonzeros; 2
    heads of 3 columns."""
    n, nnz, heads, fh = 3, 5, 2, 3
    width = heads * fh
    fwd_flops = sum(3 + 2 * fh for _ in range(nnz) for _ in range(heads))        # 90
    bwd_flops = sum(3 + 2 * fh + 2 * fh for _ in range(nnz) for _ in range(heads))  # 150
    ids = 5 * 4 + 4 * 4
    fwd_bytes = ids + n * 4 * (width + width + heads * 4)    # x, out; vl, vr, m, s
    bwd_bytes = ids + n * 4 * (4 * width + heads * 7)        # dout, x, out, dx; 7 a head
    assert heads_work.attention_work(n, nnz, width, heads) == [
        (float(fwd_flops), float(fwd_bytes)), (float(bwd_flops), float(bwd_bytes))]
    assert (fwd_flops, fwd_bytes, bwd_flops, bwd_bytes) == (90, 276, 150, 492)
    # one head is gala_bench.work's count
    assert heads_work.attention_work(5, 11, 2, 1) == work.attention_work(5, 11, 2)


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


HEADS_TRACE = [_span("gala.head_scores", 0, 10), _launch(1, 1), _kernel(1, 100, 30),
               _span("gala.attention", 10, 10), _launch(2, 11), _kernel(2, 130, 400),
               _span("gala.elu", 20, 5), _launch(3, 21), _kernel(3, 530, 10),
               _span("gala.attention.grad", 30, 10), _launch(4, 31), _kernel(4, 540, 600),
               _span("gala.head_mean", 40, 5), _launch(5, 41), _kernel(5, 1140, 20)]
COUNTS = [{"name": "gala.attention", "rows": 1000, "nnz": 50000, "width": 64, "heads": 8,
           "itemsize": 4},
          {"name": "gala.attention.grad", "rows": 900, "nnz": 50000, "width": 64, "heads": 8,
           "itemsize": 4}]


def _run(tmp_path, monkeypatch, events, config, counts, iters=2):
    monkeypatch.setattr(spans, "HERE", str(tmp_path))
    os.makedirs(tmp_path / "_trace", exist_ok=True)
    with open(tmp_path / "_trace" / "cell.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    monkeypatch.setattr(spans, "program_counts", lambda: counts)
    return types.SimpleNamespace(trace=object(), cell=types.SimpleNamespace(name="cell"),
                                 iters=iters, cm=None, config=config)


def _reader(metric):
    return cells.load_module(os.path.join(cells.HERE, "metrics", f"{metric}.py"), metric)


def test_readers_read_the_heads_spans(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, HEADS_TRACE, cells.find_cell(CELL).config, COUNTS)
    assert _reader("head_ops_ms").read(run) == pytest.approx(1e3 * 60e-6 / 2)
    want = 100.0 * (work.bound_s(*heads_work.attention_work(1000, 50000, 64, 8)[0])
                    + work.bound_s(*heads_work.attention_work(900, 50000, 64, 8)[1])) / 1000e-6
    assert _reader("heads_attn_job_roofline").read(run) == pytest.approx(want)
    monkeypatch.setattr(spans, "program_counts", lambda: COUNTS[:1])
    assert _reader("heads_attn_job_roofline").read(run) is None


@pytest.mark.parametrize("metric", ["heads_attn_job_roofline", "head_ops_ms"])
def test_heads_readers_return_none_off_the_card_and_in_one_head(tmp_path, monkeypatch, metric):
    one_head = cells.find_cell("gat2-h32.reddit").config
    # gat2-h32's traced job: one-head attention spans and counts, no head ops
    events = [e for e in HEADS_TRACE if e.get("name") not in
              ("gala.head_scores", "gala.elu", "gala.head_mean")]
    counts = [dict(c, width=32, heads=1) for c in COUNTS]
    run = _run(tmp_path, monkeypatch, events, one_head, counts)
    assert _reader(metric).read(run) is None
    untraced = types.SimpleNamespace(trace=None, cell=run.cell, iters=2, cm=None,
                                     config=cells.find_cell(CELL).config)
    assert _reader(metric).read(untraced) is None
