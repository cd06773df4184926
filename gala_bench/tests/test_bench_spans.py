"""The attribution of device activity to the program's spans
(gala_bench.spans) on a hand-made Chrome trace, and the new readers."""
import json
import os
import types

import pytest

from gala_bench import cell as cells
from gala_bench import spans, work

MAIN, AUTOGRAD, PID = 1, 2, 100


def _span(name, ts, dur, tid=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": tid, "ts": ts, "dur": dur}


def _launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": PID, "tid": tid, "ts": ts,
            "dur": 2, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _trace():
    """One training step and one inference epoch.

    - k1: launched in gala.spmm inside gala.forward inside gala.step;
    - k2: launched on the autograd thread inside gala.spmm.grad while the
      main thread waits in gala.backward;
    - k3: launched between gala.step and gala.infer, run on the device
      while the host is inside gala.infer;
    - k4: a memset launched in gala.infer;
    - a device-side copy of gala.step's annotation, which is no span."""
    return [
        _span("gala.step", 0, 100),
        _span("gala.forward", 10, 40),
        _span("gala.spmm", 20, 10),
        _launch(1, 22),
        _span("gala.backward", 60, 35),
        _span("gala.spmm.grad", 70, 10, tid=AUTOGRAD),
        _launch(2, 72, tid=AUTOGRAD),
        _launch(3, 101),
        _span("gala.infer", 110, 40),
        _launch(4, 112, name="cudaMemsetAsync"),
        _kernel(1, 200, 10),
        _kernel(2, 230, 20),
        _kernel(3, 260, 30),
        _kernel(4, 300, 5, cat="gpu_memset"),
        _span("gala.step", 200, 60, tid=7, cat="gpu_user_annotation") | {"pid": 0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": PID, "tid": MAIN, "ts": 21,
         "dur": 5},
    ]


def test_activities_count_towards_every_span_that_holds_their_launch():
    job = spans.attribute(_trace())
    assert job.spans == {"gala.step": 1, "gala.forward": 1, "gala.spmm": 1,
                         "gala.backward": 1, "gala.spmm.grad": 1, "gala.infer": 1}
    got = {name: job.seconds(name) for name in job.spans}
    assert got == pytest.approx({"gala.step": 30e-6, "gala.forward": 10e-6,
                                 "gala.spmm": 10e-6, "gala.backward": 20e-6,
                                 "gala.spmm.grad": 20e-6, "gala.infer": 5e-6})
    # inclusive, each activity once: k1 and k2 in either span
    assert job.seconds("gala.spmm", "gala.spmm.grad", "gala.step") == pytest.approx(30e-6)
    # k3 ran while the host was in gala.infer but was launched outside every span
    assert sum(s for s, held in job.activities if not held) == pytest.approx(30e-6)


def _run(tmp_path, monkeypatch, events, cm=None, iters=2):
    monkeypatch.setattr(spans, "HERE", str(tmp_path))
    os.makedirs(tmp_path / "_trace", exist_ok=True)
    with open(tmp_path / "_trace" / "cell.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    return types.SimpleNamespace(trace=object(), cell=types.SimpleNamespace(name="cell"),
                                 iters=iters, cm=cm)


def _reader(metric):
    return cells.load_module(os.path.join(cells.HERE, "metrics", f"{metric}.py"), metric)


SPAN_READERS = ("prefix_ms", "eval_ms", "spmm_job_roofline", "attn_job_roofline")
LOWER_READERS = {"layout_s": "gala.lower.layout", "relabel_s": "gala.lower.relabel",
                 "subgraph_s": "gala.lower.subgraphs"}


@pytest.mark.parametrize("metric", SPAN_READERS + tuple(LOWER_READERS))
def test_readers_return_none_without_their_spans(tmp_path, monkeypatch, metric):
    plain = [e for e in _trace() if not str(e["name"]).startswith("gala.")]
    run = _run(tmp_path, monkeypatch, plain, cm=types.SimpleNamespace())
    monkeypatch.setattr(spans, "program_counts", lambda: [])
    assert _reader(metric).read(run) is None
    untraced = types.SimpleNamespace(trace=None, cell=run.cell, iters=2, cm=None)
    assert _reader(metric).read(untraced) is None


def test_phase_readers_read_device_ms_an_epoch(tmp_path, monkeypatch):
    events = [_span("gala.prefix", 0, 10), _launch(1, 2), _kernel(1, 50, 400),
              _span("gala.test_eval", 20, 10), _launch(2, 22), _kernel(2, 500, 100)]
    run = _run(tmp_path, monkeypatch, events, iters=4)
    assert _reader("prefix_ms").read(run) == pytest.approx(0.1)
    assert _reader("eval_ms").read(run) == pytest.approx(0.025)


def test_roofline_reads_the_counts_one_to_one(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _trace())
    fwd = {"name": "gala.spmm", "rows": 1000, "nnz": 50000, "width": 32, "heads": 1,
           "itemsize": 4}
    grad = dict(fwd, name="gala.spmm.grad", rows=900)
    monkeypatch.setattr(spans, "program_counts", lambda: [fwd, grad])
    want = 100.0 * (work.bound_s(*work.spmm_work(1000, 50000, 32)[0])
                    + work.bound_s(*work.spmm_work(900, 50000, 32)[1])) / 30e-6
    assert _reader("spmm_job_roofline").read(run) == pytest.approx(want)
    monkeypatch.setattr(spans, "program_counts", lambda: [fwd, grad, grad])
    assert _reader("spmm_job_roofline").read(run) is None
    monkeypatch.setattr(spans, "program_counts", lambda: None)
    assert _reader("spmm_job_roofline").read(run) is None
    assert _reader("attn_job_roofline").read(run) is None


@pytest.mark.parametrize("metric", sorted(LOWER_READERS))
def test_lowering_readers_read_the_compiles_stages(metric):
    stages = {name: 1.5 + i for i, name in enumerate(sorted(LOWER_READERS.values()))}
    run = types.SimpleNamespace(cm=types.SimpleNamespace(lower_spans=stages))
    assert _reader(metric).read(run) == stages[LOWER_READERS[metric]]
