"""The reader of shared_dout_share on made counts: the share of the
multi-head attention gradients' edge-heads that ran on one shared dout
block, None without the counts' field (a program that records none), in
a one-head configuration and without a trace."""
import os
import types

import pytest

from gala_bench import cell as cells
from gala_bench import spans

CELL = "gat2-h8x8.reddit"


def _grad(nnz, heads, dout_heads=None):
    c = {"name": "gala.attention.grad", "rows": 900, "nnz": nnz, "width": 8 * heads,
         "heads": heads, "itemsize": 4}
    return c if dout_heads is None else dict(c, dout_heads=dout_heads)


FWD = {"name": "gala.attention", "rows": 1000, "nnz": 50000, "width": 64, "heads": 8,
       "itemsize": 4}


def _read(monkeypatch, counts, config=None, traced=True):
    monkeypatch.setattr(spans, "program_counts", lambda: counts)
    run = types.SimpleNamespace(trace=object() if traced else None,
                                cell=types.SimpleNamespace(name="cell"), iters=2, cm=None,
                                config=config or cells.find_cell(CELL).config)
    reader = cells.load_module(os.path.join(cells.HERE, "metrics", "shared_dout_share.py"),
                               "shared_dout_share")
    return reader.read(run)


def test_share_of_the_edge_heads_on_a_shared_block(monkeypatch):
    # a job's two layers twice: 8 heads on a shared block, 8 on their own;
    # and a one-head count, which takes no part
    counts = [FWD, _grad(50000, 8, 1), _grad(50000, 8, 8), _grad(30000, 8, 1),
              _grad(10000, 8, 8), _grad(70000, 1, 1)]
    assert _read(monkeypatch, counts) == pytest.approx(100.0 * 80000 / 140000)
    assert _read(monkeypatch, [FWD, _grad(50000, 8, 8)]) == 0.0


@pytest.mark.parametrize("case", ["no field", "no counts", "one head", "untraced"])
def test_share_is_none_where_there_is_nothing_to_read(monkeypatch, case):
    counts = {"no field": [FWD, _grad(50000, 8), _grad(50000, 8)],
              "no counts": None}.get(case, [FWD, _grad(50000, 8, 1)])
    config = cells.find_cell("gat2-h32.reddit").config if case == "one head" else None
    assert _read(monkeypatch, counts, config, traced=case != "untraced") is None
