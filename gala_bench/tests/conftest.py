"""Small CPU stand-ins of the benchmark's cells for its tests."""
import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# 2,000 nodes; 10,000 R-MAT draws land 20,468 nonzeros on the CPU's generator
SMALL = {"name": "small", "nodes": 2000, "features": 16, "classes": 5, "draws": 10000,
         "nonzeros_target": 20500, "graph_seed": 7,
         "split": {"train": 1000, "val": 300, "test": 500}}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json on the SMALL graph."""
    from gala_bench import cell as cells

    def make(workload: str, **traffic):
        c = cells.find_cell(workload)
        return dataclasses.replace(c, traffic=dict(SMALL, **traffic))

    return make
