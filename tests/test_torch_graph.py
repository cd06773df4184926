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
from gala_tpu_torch.ops.graph import UNIT_SLOTS, select_rows, work_unit_tables
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


def check_units(lay):
    """The work units of a row-descriptor layout: each described slot in
    exactly one unit, no unit over UNIT_SLOTS slots, a row of no slots
    still one unit, a row of at most UNIT_SLOTS one unit writing its node,
    a longer row ceil(len / UNIT_SLOTS) units whose partials are
    contiguous, in slot order, and named by the merge table."""
    u = {k: getattr(lay.units, k).numpy().astype(np.int64) for k in (
        "start", "length", "node", "part", "split_node", "split_first", "split_count")}
    start, length, node = (t.numpy().astype(np.int64)
                           for t in (lay.row_start, lay.row_len, lay.row_node))
    assert lay.units.n_units == u["start"].shape[0]
    assert (u["length"] <= UNIT_SLOTS).all() and (u["length"] >= 0).all()
    assert (np.diff(u["length"]) <= 0).all(), "longest units first"
    described = np.concatenate([np.arange(s, s + n) for s, n in zip(start, length)] + [[]])
    covered = np.concatenate([np.arange(s, s + n) for s, n in zip(u["start"], u["length"])]
                             + [[]])
    np.testing.assert_array_equal(np.sort(covered), np.sort(described))
    n_units = np.maximum(-(-length // UNIT_SLOTS), 1)
    np.testing.assert_array_equal(np.bincount(u["node"], minlength=node.max() + 1)[node],
                                  n_units)
    whole = u["part"] < 0
    np.testing.assert_array_equal(np.sort(u["node"][whole]), np.sort(node[n_units == 1]))
    split = n_units > 1
    np.testing.assert_array_equal(u["split_node"], node[split])
    np.testing.assert_array_equal(u["split_count"], n_units[split])
    np.testing.assert_array_equal(u["split_first"],
                                  np.cumsum(u["split_count"]) - u["split_count"])
    assert lay.units.n_partials == int(u["split_count"].sum()) == int((~whole).sum())
    by_part = np.argsort(u["part"][~whole])
    part_start = u["start"][~whole][by_part]
    part_node = u["node"][~whole][by_part]
    np.testing.assert_array_equal(part_node, np.repeat(u["split_node"], u["split_count"]))
    for r, (n, first, count) in enumerate(zip(u["split_node"], u["split_first"],
                                              u["split_count"])):
        row = np.flatnonzero(node == n)[0]
        np.testing.assert_array_equal(part_start[first : first + count],
                                      start[row] + UNIT_SLOTS * np.arange(count))
    return u


def _layouts(case):
    """Every row-descriptor layout of a case graph, with its name."""
    g, und = host_graph(case, "torch")
    bell = TGraph.from_host(g, strategy="bell", undirected=und, device="cpu", attention=True)
    ell = TGraph.from_host(g, strategy="ell", undirected=und, device="cpu", edge_vals=True)
    seg = TGraph.from_host(g, strategy="segment", undirected=und, device="cpu")
    return {"bell": bell.bell, "t_bell": bell.t_bell, "attn fwd": bell.attn.fwd,
            "attn t": bell.attn.t, "ell": ell.ell, "t_ell": ell.t_ell, "seg": seg.seg,
            "t_seg": seg.t_seg}


@pytest.mark.parametrize("case", CASES)
def test_work_units_cover_each_slot_once(case):
    for name, lay in _layouts(case).items():
        u = check_units(lay)
        if case == "hub_selfloops" and name in ("bell", "attn fwd", "seg"):
            assert (u["part"] >= 0).any(), f"{name}: the hub should be split"
        if name in ("seg", "t_seg"):  # rows of no slots: padded nodes
            assert (lay.row_len == 0).any() and (u["length"] == 0).any()


@pytest.mark.parametrize("length", [0, UNIT_SLOTS - 1, UNIT_SLOTS, UNIT_SLOTS + 1,
                                    2 * UNIT_SLOTS, 52 * UNIT_SLOTS])
def test_work_units_of_a_row_of_each_length(length):
    """One row of `length` slots between rows of 3 and 0 slots."""
    lens = np.array([3, length, 0], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    t = work_unit_tables(starts, lens, [5, 6, 7])
    n = max(-(-length // UNIT_SLOTS), 1)
    assert t["start"].shape[0] == n + 2
    mine = t["node"] == 6
    assert mine.sum() == n and sorted(t["length"][mine].tolist(), reverse=True) == [
        min(UNIT_SLOTS, length - UNIT_SLOTS * k) for k in range(n)]
    if n == 1:
        assert (t["part"][mine] == -1).all() and t["split_node"].size == 0
    else:
        assert sorted(t["part"][mine].tolist()) == list(range(n))
        assert t["split_node"].tolist() == [6] and t["split_count"].tolist() == [n]
        by_part = np.argsort(t["part"][mine])
        assert t["start"][mine][by_part].tolist() == [3 + UNIT_SLOTS * k for k in range(n)]
    assert t["length"][t["node"] == 7].tolist() == [0]  # the empty row keeps its unit


@pytest.mark.parametrize("case", CASES)
def test_hub_units_are_gala_tpu_virtual_rows(case):
    """With UNIT_SLOTS = K_BIG, each hub's units on the binned layouts are
    the JAX package's virtual rows (big_vrow) of the same host graph: the
    same slots, in the same order, for the hub's node."""
    from gala_tpu.data.ell import K_BIG

    assert UNIT_SLOTS == K_BIG
    jg, tg, _ = graph_pair(case)
    for jb, tb in ((jg.bell, tg.bell), (jg.t_bell, tg.t_bell)):
        if not tb.n_big:
            continue
        u = tb.units
        big_off = sum(k * n for k, n in zip(jb.bin_ks, jb.bin_counts))
        vrow = np.asarray(jb.big_vrow)
        part_start = np.empty(u.n_partials, np.int64)
        split = u.part >= 0
        part_start[u.part[split].numpy()] = u.start[split].numpy()
        hub_nodes = tb.row_node.numpy()[-tb.n_big:]
        np.testing.assert_array_equal(u.split_node.numpy(), hub_nodes)
        for i, (first, count) in enumerate(zip(u.split_first.numpy(), u.split_count.numpy())):
            want = big_off + K_BIG * np.flatnonzero(vrow == i)
            np.testing.assert_array_equal(part_start[first : first + count], want)
        assert (u.length[split] == K_BIG).all()


def test_select_rows_cuts_units_anew():
    lay = _layouts("hub_selfloops")["bell"]
    short = select_rows(lay, lay.row_len <= UNIT_SLOTS)
    assert short.units.n_partials == 0 and short.n_real == lay.n_real
    assert short.units.n_units == int((lay.row_len <= UNIT_SLOTS).sum())
    check_units(short)


def test_dense_layout_matches_jax():
    jg, tg, _ = graph_pair("hub_selfloops", strategy="dense")
    assert tg.strategy == jg.strategy == "dense"
    _eq(tg.a_dense, jg.a_dense)
    _eq(tg.deg, jg.deg)


def test_choose_strategy_gate():
    from gala_tpu.ops.graph import choose_strategy as jchoose
    from gala_tpu_torch.ops.graph import choose_strategy as tchoose

    for n in (1000, 16384, 16392, 200_000):
        for edge_vals in (False, True):
            assert (tchoose(n, n, 10 * n, edge_vals=edge_vals)
                    == jchoose(n, n, 10 * n, edge_vals=edge_vals))


@pytest.mark.parametrize("strategy", ["ell", "segment", "segment_scan", "pallas_bell"])
def test_unported_strategies_raise(strategy):
    """'pallas_bell' still raises; 'ell' and the 'segment' strategies are
    ported and build gala_tpu's edge lists (and, on 'ell', its ELL
    arrays), held in full by tests/test_torch_edge.py."""
    g, _ = host_graph("directed", "torch")
    if strategy == "pallas_bell":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TGraph.from_host(g, strategy=strategy, device="cpu")
        return
    gj, und = host_graph("directed", "jax")
    jg = JGraph.from_host(gj, strategy=strategy, undirected=und)
    tg = TGraph.from_host(g, strategy=strategy, undirected=und, device="cpu")
    assert tg.strategy == jg.strategy == strategy and tg.e_pad == jg.e_pad
    for name in ("src", "dst", "vals", "t_src", "t_dst", "t_vals", "t_perm", "row_ptr"):
        _eq(getattr(tg, name), getattr(jg, name))
    if strategy == "ell":
        _eq(tg.ell.flat_cols.view(-1, tg.ell.k), jg.ell_cols)
        _eq(tg.t_ell.perm.view(-1, tg.t_ell.k), jg.t_ell_perm)
