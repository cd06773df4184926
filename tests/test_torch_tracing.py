"""The port's spans and work counters (gala_tpu_torch.utils.profiling):
free when no profiler records, the lowering's stages in
CompiledModel.lower_spans, the training job's spans and the SpMM's
counts in a profiled CPU job, and no number of the job changed by the
profiler."""
import collections
import glob
import json
import os
import time

import pytest
import torch

import gala_tpu_torch
from __graft_entry__ import GAT_DSL, GCN_DSL
from gala_tpu_torch.data.synthetic import synthetic_dataset
from gala_tpu_torch.utils import profiling
from gala_tpu_torch.utils.profiling import annotate, count, counts, marker, profile_trace

torch.set_num_threads(2)

STAGES = ("gala.lower.ir", "gala.lower.sample", "gala.lower.relabel", "gala.lower.subgraphs",
          "gala.lower.layout", "gala.lower.inputs")
JOB_SPANS = {"gala.prefix", "gala.epoch_inputs", "gala.step", "gala.forward", "gala.backward",
             "gala.optimizer", "gala.snapshot", "gala.infer", "gala.test_eval", "gala.fence"}
ITERS = 6


def _data():
    return synthetic_dataset(n=600, avg_degree=8, n_feats=24, n_classes=5, seed=0)


def _compile(source):
    return gala_tpu_torch.compile_source(source, mode="train", data=_data(), strategy="bell",
                                         device="cpu")


@pytest.fixture(scope="module")
def gcn():
    return _compile(GCN_DSL)


def _raise(name):
    raise AssertionError(f"record_function({name!r}) outside a profiler")


def test_marker_emits_nothing_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", _raise)

    @annotate("gala.test_fn")
    def double(x):
        return 2 * x

    with marker("gala.test"):
        assert double(3) == 6
    timed = {}
    with marker("gala.test_timed", into=timed):
        pass
    with marker("gala.test_timed", into=timed):
        time.sleep(0.001)
    assert set(timed) == {"gala.test_timed"} and timed["gala.test_timed"] >= 0.001


def test_marker_emits_one_range_under_a_profiler(monkeypatch):
    real, names = profiling.record_function, []

    def spy(name):
        names.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", spy)
    with torch.profiler.profile() as prof:
        with marker("gala.test"):
            torch.ones(8).sum()
    assert names == ["gala.test"]
    assert "gala.test" in {e.name for e in prof.events()}


def test_count_records_only_under_a_profiler():
    profiling.clear_counts()
    count("gala.test", rows=3)
    assert counts() == []
    with torch.profiler.profile():
        count("gala.test", rows=3, nnz=5)
    assert counts() == [{"name": "gala.test", "rows": 3, "nnz": 5}]
    profiling.clear_counts()
    assert counts() == []


@pytest.mark.parametrize("source", [GCN_DSL, GAT_DSL], ids=["gcn", "gat"])
def test_lower_spans_hold_every_stage(source):
    t0 = time.perf_counter()
    cm = _compile(source)
    wall = time.perf_counter() - t0
    spans = cm.lower_spans
    assert set(STAGES) <= set(spans)
    assert all(spans[s] >= 0.0 for s in STAGES)
    assert sum(spans[s] for s in STAGES) <= wall
    if source is GAT_DSL:
        assert 0.0 < spans["gala.lower.layout.attention"] <= spans["gala.lower.layout"]


def _hand_count(cm) -> collections.Counter:
    """The SpMM calls of an ITERS-epoch GCN job, by hand.

    The invariant prefix runs once on the training subgraphs and once on
    the full graph: the degrees (A @ ones, width 1) and the normalized
    features (width F), both on the set's first graph.  Each training
    step aggregates the hidden layer (width 32) on the set's second graph
    (the full graph on validation epochs 0 and 5, the layer-2 training
    subgraph otherwise), with one gradient on its transpose; each
    inference epoch repeats that forward; the test accuracy of each of
    the two validation snapshots aggregates on the full graph."""
    full, sub = cm.full_graphs, cm.train_graphs
    feats, hidden = int(cm.x.shape[1]), 32
    valid = [e % 5 == 0 for e in range(ITERS)]

    def rec(name, g, width, rows=None):
        return json.dumps({"name": name, "rows": g.n_nodes if rows is None else rows,
                           "nnz": g.n_edges, "width": width, "heads": 1, "itemsize": 4},
                          sort_keys=True)

    want = collections.Counter()
    for gs in (sub, full):
        want.update([rec("gala.spmm", gs[0], 1), rec("gala.spmm", gs[0], feats)])
    for v in valid:
        g = (full if v else sub)[1]
        want.update([rec("gala.spmm", g, hidden), rec("gala.spmm", g, hidden),
                     rec("gala.spmm.grad", g, hidden, rows=g.n_cols)])
    want.update([rec("gala.spmm", full[1], hidden)] * sum(valid))
    return want


def test_profiled_gcn_job_holds_its_spans_and_counts(gcn, tmp_path):
    with profile_trace(str(tmp_path)):
        gcn.train(iters=ITERS)
    trace, = [p for p in glob.glob(str(tmp_path / "*.json")) if not p.endswith(".counts.json")]
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert JOB_SPANS <= set(names)
    assert names["gala.step"] == names["gala.infer"] == ITERS
    assert names["gala.prefix"] == 2 and names["gala.test_eval"] == 1
    with open(trace[: -len(".json")] + ".counts.json") as f:
        written = json.load(f)
    assert written == counts()
    got = collections.Counter(json.dumps(c, sort_keys=True) for c in written)
    assert got == _hand_count(gcn)
    assert names["gala.spmm"] == sum(v for k, v in got.items() if '"gala.spmm"' in k)
    assert names["gala.spmm.grad"] == sum(v for k, v in got.items() if "gala.spmm.grad" in k)


def test_the_profiler_changes_no_number(gcn, tmp_path):
    plain = gcn.train(iters=ITERS, params=gcn.make_params(0))
    with profile_trace(str(tmp_path)):
        traced = gcn.train(iters=ITERS, params=gcn.make_params(0))
    assert plain.losses == traced.losses
    a, b = dict(plain.params.named_parameters()), dict(traced.params.named_parameters())
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
