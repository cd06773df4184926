"""The port's host utilities against gala_tpu's, on one host graph (the
synthetic stand-in of tests/test_torch_train.py, built by each package's
own generator): MatrixMarket read and write (data/mtx.py), the matrix
statistics (utils/stats.py: MtxStats, DistStats, tile_stats,
check_equal, approx_range, degree_entropy), all verbatim copies, held
equal exactly; and profile_trace, the port of gala_tpu's profiler
markers onto torch.profiler, writing a Chrome trace with a marker
region on the CPU."""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import gala_tpu.data.mtx as jmtx
import gala_tpu.utils.stats as jstats
import gala_tpu_torch.data.mtx as tmtx
import gala_tpu_torch.utils.stats as tstats
from gala_tpu.data.csr import densify as jdensify
from gala_tpu.data.synthetic import synthetic_dataset as jax_dataset
from gala_tpu_torch.data.csr import densify
from gala_tpu_torch.data.synthetic import synthetic_dataset as torch_dataset
from gala_tpu_torch.utils.profiling import annotate, marker, profile_trace


def _graphs():
    make = dict(n=600, avg_degree=8, n_feats=24, n_classes=5, seed=0)
    return torch_dataset(**make)[0], jax_dataset(**make)[0]


def _same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mtx_round_trip_reads_and_writes_as_jax(tmp_path):
    g, jg = _graphs()
    ours, theirs = str(tmp_path / "torch.mtx"), str(tmp_path / "jax.mtx")
    tmtx.write_mtx(ours, g)
    jmtx.write_mtx(theirs, jg)
    assert open(ours).read() == open(theirs).read()
    back, jback = tmtx.read_mtx(ours), jmtx.read_mtx(ours)
    np.testing.assert_array_equal(densify(back), densify(g))
    np.testing.assert_array_equal(densify(back), jdensify(jback))
    _same(dataclasses.asdict(back), dataclasses.asdict(jback))


@pytest.mark.parametrize("what", ["MtxStats", "DistStats", "tile_stats", "approx_range",
                                  "degree_entropy"])
def test_stats_equal_jax(what):
    g, jg = _graphs()
    calls = {
        "MtxStats": lambda s, h: s.MtxStats.of(h),
        "DistStats": lambda s, h: s.DistStats.of(np.bincount(h.dst, minlength=h.n_rows)),
        "tile_stats": lambda s, h: s.tile_stats(h, blk_r=64, blk_c=64),
        "approx_range": lambda s, h: s.approx_range(h, n_tiles=4),
        "degree_entropy": lambda s, h: s.degree_entropy(h, frac=1.0),
    }
    _same(calls[what](tstats, g), calls[what](jstats, jg))


def test_check_equal_equals_jax():
    g, jg = _graphs()
    cases = [lambda h: h, lambda h: dataclasses.replace(h, vals=h.vals * 2.0),
             lambda h: dataclasses.replace(h, n_cols=h.n_cols + 1)]
    for change in cases:
        for check_vals in (True, False):
            got = tstats.check_equal(g, change(g), check_vals=check_vals)
            assert got == jstats.check_equal(jg, change(jg), check_vals=check_vals)
    assert tstats.check_equal(g, cases[1](g)) == (False, "values differ")


def test_profile_trace_writes_a_chrome_trace_with_marker_regions(tmp_path, monkeypatch):
    """The trace lands under the given directory (and under
    $GALA_TPU_TRACE_DIR by default, gala_tpu's variable) and holds the
    marker's and the annotated function's regions."""
    @annotate("annotated_fn")
    def double(x):
        return x * 2

    monkeypatch.setenv("GALA_TPU_TRACE_DIR", str(tmp_path / "default"))
    for given in (str(tmp_path / "given"), None):
        with profile_trace(given) as log_dir:
            with marker("gala_region"):
                torch.ones(64).sum()
            double(torch.ones(8))
        assert log_dir == (given or str(tmp_path / "default"))
        traces = [p for p in glob.glob(os.path.join(log_dir, "*.json"))
                  if not p.endswith(".counts.json")]
        assert len(traces) == 1
        assert os.path.exists(traces[0][: -len(".json")] + ".counts.json")
        with open(traces[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"gala_region", "annotated_fn"} <= names
    assert double.__name__ == "double"
