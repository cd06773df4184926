"""The plain reference against the port's CPU path on a small graph: the
losses of a few epochs and the parameters after them, from the same
weights, on the layouts the card runs (bell) and on the dense one."""
import copy

import pytest
import torch

import gala_tpu_torch
from gala_bench import cell as cells
from gala_bench import graphgen, reference

EPOCHS = 6  # epochs 0 and 5 on the full graph, 1-4 on the subgraphs


@pytest.mark.parametrize("strategy", ["bell", "dense"])
@pytest.mark.parametrize("workload", ["gcn2-h32.reddit", "gat2-h32.reddit"])
def test_reference_follows_the_port(small_cell, workload, strategy):
    c = small_cell(workload)
    g = graphgen.make_graph(c.traffic, "cpu")
    cm = gala_tpu_torch.compile_source(c.config["dsl"], mode="train",
                                       data=graphgen.host_data(g), device="cpu",
                                       strategy=strategy)
    assert cm.full_graphs[0].strategy == strategy
    weights = reference.init_weights(
        c.model.shapes(g.feats.shape[1], c.config["hidden"], g.n_classes), 5, "cpu")
    params = cells.program_params(cm, weights)
    res = cm.train(iters=EPOCHS, params=copy.deepcopy(params))

    rg = reference.RefGraph.from_edges(g.row, g.col, g.n)
    loop = {k: c.config[k] for k in ("lr", "weight_decay", "valid_step")}
    ref = reference.follow(c.model, rg, g.feats, g.labels, g.masks["train"], weights, loop,
                           EPOCHS)
    assert res.losses == pytest.approx(ref.losses, rel=2e-6)
    got = dict(res.params.named_parameters())
    for k, want in ref.params.items():
        torch.testing.assert_close(got[k].detach(), want, rtol=0, atol=2e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0])
    assert reference.round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10,
                                                 -3.0]
