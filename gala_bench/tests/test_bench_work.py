"""The work counters against hand counts on a 5-node graph."""
import pytest
import torch

from gala_bench import reference, work

# 5 nodes, self loops, edges 0-1, 1-2, 2-3 both ways: 11 nonzeros
ROW = torch.tensor([0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4])
COL = torch.tensor([0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4])


def test_spmm_work_by_hand():
    # width 2: 11 adds a column = 22; bytes 11 ids + 6 offsets (4 B each)
    # + 5 rows in and 5 rows out of 2 floats = 44 + 24 + 80
    assert work.spmm_work(5, 11, 2) == [(22.0, 148.0), (22.0, 148.0)]


def test_attention_work_by_hand():
    fwd, bwd = work.attention_work(5, 11, 2)
    # forward: 11 edges x (2*2 + 3); ids 68 B; rows 5 x (2*2 + 4) floats
    assert fwd == (77.0, 68.0 + 5 * 8 * 4)
    # backward: 11 x (4*2 + 3); rows 5 x (4*2 + 7) floats
    assert bwd == (121.0, 68.0 + 5 * 15 * 4)


def test_bound_and_roofline():
    assert work.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.roofline_pct([(67e12, 0.0), (0.0, 3.35e12)], 4.0) == pytest.approx(50.0)


def test_model_flops_by_hand():
    # GCN, n 5, 3 features, hidden 2, 4 classes, 11 nonzeros full and
    # [9, 5] in the subgraphs, 3 epochs, every 2nd on the full graph:
    # dense 2*5*(3*2 + 2*4) = 140 a forward; the second aggregation
    # 2 * e * min(2, 4); epochs 0 and 2 full (3 + 1 + 1 forwards),
    # epoch 1 on the subgraphs (3 + 1); the prefix 2 * e * min(3, 2) on
    # the full graph and on subgraph 0.
    full, sub = 140 + 2 * 11 * 2, 140 + 2 * 5 * 2
    want = 2 * 5 * full + 4 * sub + 2 * 11 * 2 + 2 * 9 * 2
    assert work.model_flops_per_job("gcn", 5, 3, 2, 4, 11, [9, 5], 3, 2) == want
    # GAT: both aggregations 2 * e * min(d_in, d_out), plus 2 n d_out 2
    # for the two score columns and 4 an edge
    def fwd(e0, e1):
        return (140 + 2 * e0 * 2 + 2 * 5 * 2 * 2 + 4 * e0
                + 2 * e1 * 2 + 2 * 5 * 4 * 2 + 4 * e1)
    want = 2 * 5 * fwd(11, 11) + 4 * fwd(9, 5)
    assert work.model_flops_per_job("gat", 5, 3, 2, 4, 11, [9, 5], 3, 2) == want


def test_subgraph_counts_by_hand():
    # train = {0}: layer 1 keeps the edges into node 0 (2); layer 0 the
    # edges into 0 and its neighbour 1 (5)
    train = torch.tensor([True, False, False, False, False])
    rows = reference.layer_rows(ROW, COL, train, 2)
    assert [int(m[ROW].sum()) for m in rows] == [5, 2]
    g = reference.RefGraph.from_edges(ROW, COL, 5)
    assert [s.nnz for s in reference.training_subgraphs(g, train, 2)] == [5, 2]
    assert g.degrees()[:, 0].tolist() == [2, 3, 3, 2, 1]
