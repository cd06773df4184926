"""The control comes out not correct: the reference computed one step of
precision below the configuration's (its dense products in TF32) put in
the program's place, held to each cell's limits.  On the card it was read
at the cells' own sizes (calibrate.py readings, PERF.md); here at a size
a test run holds."""
import json
import os

import pytest
import torch

from gala_bench import cell as cells
from gala_bench import check, graphgen, reference

BENCH = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_tf32_control_is_not_correct(small_cell, workload):
    c = small_cell(workload)
    g = graphgen.make_graph(c.traffic, "cpu")
    rg = reference.RefGraph.from_edges(g.row, g.col, g.n)
    loop = {k: c.config[k] for k in ("lr", "weight_decay", "valid_step")}
    weights = reference.init_weights(
        c.model.shapes(g.feats.shape[1], c.config["hidden"], g.n_classes), 17, "cpu")

    def follow(ops):
        return reference.follow(c.model, rg, g.feats, g.labels, g.masks["train"], weights,
                                loop, cells.STEPS, ops=ops)

    ref, control = follow(reference.Ops()), follow(reference.Ops(tf32=True))
    numbers = check.gaps([control.losses], control.grads, control.params, ref,
                         reference.leaves(weights), ref.raw_grads, cells.STEPS)
    assert not check.judge(numbers, c.limits), numbers
    # and the f32 reference run twice is correct
    again = follow(reference.Ops())
    numbers = check.gaps([again.losses], again.grads, again.params, ref,
                         reference.leaves(weights), ref.raw_grads, cells.STEPS)
    assert check.judge(numbers, c.limits), numbers
