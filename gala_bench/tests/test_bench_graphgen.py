"""The graph generator: deterministic per graph_seed, on its target."""
import pytest
import torch

from conftest import SMALL
from gala_bench import graphgen


def test_same_graph_seed_same_graph():
    a = graphgen.make_graph(SMALL, "cpu")
    b = graphgen.make_graph(SMALL, "cpu")
    for x, y in [(a.crow, b.crow), (a.col, b.col), (a.feats, b.feats), (a.labels, b.labels)]:
        assert torch.equal(x, y)
    assert all(torch.equal(a.masks[k], b.masks[k]) for k in a.masks)
    c = graphgen.make_graph(dict(SMALL, graph_seed=8), "cpu", check_nnz=False)
    assert not torch.equal(a.col[: c.nnz], c.col[: a.nnz]) or a.nnz != c.nnz


def test_reaches_its_target_and_keeps_the_graph_sound():
    g = graphgen.make_graph(SMALL, "cpu")
    assert abs(g.nnz - SMALL["nonzeros_target"]) <= 0.01 * SMALL["nonzeros_target"]
    keys = g.row * g.n + g.col
    assert torch.all(keys[1:] > keys[:-1])                       # sorted, no duplicates
    assert torch.equal(torch.sort(g.col * g.n + g.row).values, keys)  # undirected
    assert int((g.row == g.col).sum()) == g.n                    # one self loop a node
    assert torch.equal(g.crow[1:] - g.crow[:-1], torch.bincount(g.row, minlength=g.n))
    sizes = {k: int(v.sum()) for k, v in g.masks.items()}
    assert sizes == SMALL["split"]
    assert not (g.masks["train"] & g.masks["test"]).any()


def test_misses_of_the_target_raise():
    with pytest.raises(ValueError, match="nonzeros"):
        graphgen.make_graph(dict(SMALL, draws=5000), "cpu")


def test_host_data_is_the_ports_csr():
    g = graphgen.make_graph(SMALL, "cpu")
    csr, feats, labels, masks = graphgen.host_data(g)
    assert csr.n_edges == g.nnz and csr.row_ptr[-1] == g.nnz
    assert (csr.dst == g.row.numpy()).all() and (csr.src == g.col.numpy()).all()
    assert feats.shape == (SMALL["nodes"], SMALL["features"])
    assert set(masks) == {"train", "val", "test"}
