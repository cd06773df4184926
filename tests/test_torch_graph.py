"""gala_tpu_torch.ops.graph against gala_tpu.ops.graph: the port's device
layouts hold exactly the arrays the JAX package builds from the same host
graph, and the kernel's row descriptors cover every slot once.

The graph cases (tests/test_torch_kernels.py) are built once with each
package's own host modules."""
import numpy as np
import pytest
import torch

import gala_tpu.data.csr as jcsr
import gala_tpu.data.ell as jell
import gala_tpu.data.reordering as jreo
import gala_tpu.data.subgraph as jsub
import gala_tpu.data.synthetic as jsyn
from gala_tpu.ops.graph import Graph as JGraph
from gala_tpu_torch.ops.graph import Graph as TGraph
from tests.test_torch_kernels import CASES, build_case, torch_case

torch.set_num_threads(2)


def host_graph(case: str, side: str):
    """(HostCSR, undirected flag) built by one package: side 'jax' uses
    gala_tpu's host modules, 'torch' the port's copies."""
    if side == "torch":
        return torch_case(case)
    return build_case(case, jsyn, jell, jreo, jsub, jcsr)


def graph_pair(case: str, strategy: str = "bell"):
    gj, und = host_graph(case, "jax")
    gt_, _ = host_graph(case, "torch")
    return (JGraph.from_host(gj, strategy=strategy, undirected=und),
            TGraph.from_host(gt_, strategy=strategy, undirected=und, device="cpu"),
            gj)


def _eq(t, a):
    if a is None:
        assert t is None
        return
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def _bell_eq(tb, jb):
    _eq(tb.flat_cols, jb.flat_cols)
    assert len(tb.bin_vals) == len(jb.bin_vals)
    for tv, jv in zip(tb.bin_vals, jb.bin_vals):
        _eq(tv, jv)
    _eq(tb.big_vals, jb.big_vals)
    _eq(tb.big_vrow, jb.big_vrow)
    _eq(tb.diag, jb.diag)
    _eq(tb.out_index, jb.out_index)
    assert (tb.bin_ks, tb.bin_counts, tb.n_big, tb.n_real) == (
        jb.bin_ks, jb.bin_counts, jb.n_big, jb.n_real)


@pytest.mark.parametrize("case", CASES)
def test_bell_layout_matches_jax(case):
    jg, tg, _ = graph_pair(case)
    for attr in ("n_nodes", "n_cols", "n_pad", "c_pad", "n_edges", "undirected", "strategy"):
        assert getattr(tg, attr) == getattr(jg, attr), attr
    _eq(tg.deg, jg.deg)
    _bell_eq(tg.bell, jg.bell)
    _bell_eq(tg.t_bell, jg.t_bell)
    assert (tg.t_bell is tg.bell) == (jg.t_bell is jg.bell)
    # what each case is there to cover
    if case == "symmetric_relabelled":
        assert tg.t_bell is tg.bell and tg.bell.out_index is None
    if case in ("directed", "train_subgraph", "hub_selfloops"):
        assert tg.t_bell is not tg.bell
    if case == "train_subgraph":
        assert tg.bell.out_index is not None
    if case == "hub_selfloops":
        assert tg.bell.n_big and tg.t_bell.n_big and tg.bell.diag is not None
        assert (tg.deg[: tg.n_nodes] == 0).any()


@pytest.mark.parametrize("case", CASES)
def test_row_descriptors_cover_each_slot_once(case):
    _, tg, _ = graph_pair(case)
    for b in {id(tg.bell): tg.bell, id(tg.t_bell): tg.t_bell}.values():
        start, length = b.row_start.numpy(), b.row_len.numpy()
        slots = np.concatenate([np.arange(s, s + l) for s, l in zip(start, length)])
        np.testing.assert_array_equal(np.sort(slots), np.arange(b.flat_cols.shape[0]))
        assert np.unique(slots).size == slots.size
        # every real node is written by exactly one row
        np.testing.assert_array_equal(np.sort(b.row_node.numpy()), np.arange(b.n_real))
        # a hub's one row spans exactly its virtual rows
        if b.n_big:
            nvirt = np.bincount(b.big_vrow.numpy(), minlength=b.n_big)
            np.testing.assert_array_equal(length[-b.n_big:], nvirt * b.big_vals.shape[1])


def test_dense_layout_matches_jax():
    jg, tg, _ = graph_pair("hub_selfloops", strategy="dense")
    assert tg.strategy == jg.strategy == "dense"
    _eq(tg.a_dense, jg.a_dense)
    _eq(tg.deg, jg.deg)


def test_choose_strategy_gate():
    from gala_tpu.ops.graph import choose_strategy as jchoose
    from gala_tpu_torch.ops.graph import choose_strategy as tchoose

    for n in (1000, 16384, 16392, 200_000):
        assert tchoose(n, n) == jchoose(n, n, 10 * n)


@pytest.mark.parametrize("strategy", ["ell", "segment", "segment_scan", "pallas_bell"])
def test_unported_strategies_raise(strategy):
    g, _ = host_graph("directed", "torch")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TGraph.from_host(g, strategy=strategy)
