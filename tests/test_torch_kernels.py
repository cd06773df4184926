"""The bell SpMM CUDA kernel against its plain PyTorch version, on the card.

This file imports neither jax nor gala_tpu, so it runs on a machine with
the GPU, where JAX is not installed (tests/conftest.py imports jax, hence
--noconftest):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Elsewhere the card tests skip.  The graph cases are also the ones
tests/test_torch_graph.py and tests/test_torch_spmm.py hold against
gala_tpu, built there with each package's own host modules.
"""
import os

import numpy as np
import pytest
import torch

import gala_tpu_torch.data.csr as tcsr
import gala_tpu_torch.data.ell as tell
import gala_tpu_torch.data.reordering as treo
import gala_tpu_torch.data.subgraph as tsub
import gala_tpu_torch.data.synthetic as tsyn
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.kernels import bell_spmm as kernel

CASES = ["symmetric_relabelled", "directed", "train_subgraph", "hub_selfloops"]
WIDTHS = [1, 32, 40, 128]


def _synthetic(syn, undirected):
    return syn.synthetic_dataset(n=600, avg_degree=8, n_feats=24, n_classes=5,
                                 seed=11, undirected=undirected)


def _relabelled(syn, ell, reo):
    g, feats, labels, masks = _synthetic(syn, True)
    order = ell.bell_order(g)
    g, feats, labels, masks, _ = reo.apply_reorder(g, order, feats, labels, masks)
    return g, masks


def _hub_coo(seed=5):
    """Weighted directed graph: a hub of in-degree > 300 (3 virtual rows),
    a source of out-degree 300 (a hub of the transpose), self-loops on a
    third of the nodes (so the layout has a diag) and 100 isolated rows."""
    rng = np.random.default_rng(seed)
    n = 500
    src = rng.integers(0, 400, 1500)
    dst = rng.integers(0, 400, 1500)
    src = np.concatenate([src, rng.integers(0, 400, 320), np.full(300, 9)])
    dst = np.concatenate([dst, np.full(320, 7), rng.integers(0, 400, 300)])
    loops = np.arange(0, 400, 3)
    src = np.concatenate([src, loops])
    dst = np.concatenate([dst, loops])
    vals = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
    return src, dst, vals, n


def build_case(case: str, syn, ell, reo, sub, csr):
    """(HostCSR, undirected flag for Graph.from_host) of one graph case,
    built with the given package's host modules."""
    if case == "symmetric_relabelled":
        return _relabelled(syn, ell, reo)[0], None
    if case == "directed":
        return _synthetic(syn, False)[0], None
    if case == "train_subgraph":
        g, masks = _relabelled(syn, ell, reo)
        return sub.mask_subgraphs(g, masks["train"], 2)[0], False
    if case == "hub_selfloops":
        src, dst, vals, n = _hub_coo()
        return csr.coo_to_csr(src, dst, vals, n_rows=n), None
    raise ValueError(case)


def torch_case(case: str):
    return build_case(case, tsyn, tell, treo, tsub, tcsr)


def test_kernel_source_targets_hopper_and_names_what_it_replaces():
    with open(kernel._SRC) as f:
        src = f.read()
    assert "gala_tpu/ops/pallas/bell_spmm.py::bell_spmm_planned" in src
    assert "3.35 TB/s" in src
    assert "arch=compute_90a,code=sm_90a" in kernel._NVCC_FLAGS
    assert os.path.dirname(kernel._SRC).endswith(os.path.join("gala_tpu_torch", "csrc"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version_on_the_card(cuda, case, f):
    """|kernel - plain| <= 1e-4 + 1e-4 * (|A| @ |x|) per element, in f32:
    the two sum a row's slots in different orders, and a sum's rounding
    error grows with the magnitudes of its terms, not with the result
    (the case graphs' values are positive, so |A| = A)."""
    host, undirected = torch_case(case)
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn((g.c_pad, f), generator=gen, device=cuda)
    dz = torch.randn((g.n_pad, f), generator=gen, device=cuda)
    for lay, inp, n_out in ((g.bell, x, g.n_pad), (g.t_bell, dz, g.c_pad)):
        launches = kernel.counts.launches
        out = kernel.bell_spmm(lay, inp, n_out)
        torch.cuda.synchronize()
        assert kernel.counts.launches == launches + 1
        ref = kernel.bell_spmm_reference(lay, inp, n_out)
        scale = kernel.bell_spmm_reference(lay, inp.abs(), n_out)
        assert ((out - ref).abs() <= 1e-4 + 1e-4 * scale).all()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    host, _ = torch_case("hub_selfloops")
    g = Graph.from_host(host, strategy="bell", device=cuda)
    x = torch.zeros((g.c_pad, 8), device=cuda)
    with pytest.raises(TypeError):
        kernel.bell_spmm(g.bell, x.double(), g.n_pad)
    with pytest.raises(ValueError):
        kernel.bell_spmm(g.bell, torch.zeros((8, g.c_pad), device=cuda).t(), g.n_pad)
    with pytest.raises(ValueError):
        kernel.bell_spmm(g.bell, x.cpu(), g.n_pad)
