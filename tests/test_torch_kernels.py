"""The CUDA kernels (bell SpMM and its sampled form, the three attention
kernels, SDDMM, row gather) against their plain PyTorch versions, on the
card.

This file imports neither jax nor gala_tpu, so it runs on a machine with
the GPU, where JAX is not installed (tests/conftest.py imports jax, hence
--noconftest):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Elsewhere the card tests skip.  The graph cases are also the ones
tests/test_torch_graph.py and tests/test_torch_spmm.py hold against
gala_tpu, built there with each package's own host modules.

Each kernel test runs at float32 and at bfloat16 (the kernels' bf16
forms: bf16 tables, f32 sums).  The plain versions take the same bf16
inputs and compute in f32, so the tolerances are the f32 ones, plus one
bf16 unit in the last place (`_build.rounding_slack`) where the result
itself is bf16 (the SpMM and the SDDMM), which each side rounds once.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import gala_tpu_torch.data.csr as tcsr
import gala_tpu_torch.data.ell as tell
import gala_tpu_torch.data.reordering as treo
import gala_tpu_torch.data.subgraph as tsub
import gala_tpu_torch.data.synthetic as tsyn
from gala_tpu_torch.ops.graph import UNIT_SLOTS, Graph, masked_units, select_rows, shifted_slots
from gala_tpu_torch.ops.kernels import _build
from gala_tpu_torch.ops.kernels import attn_bell
from gala_tpu_torch.ops.kernels import bell_spmm as kernel
from gala_tpu_torch.ops.kernels import gather
from gala_tpu_torch.ops.kernels import sddmm

CASES = ["symmetric_relabelled", "directed", "train_subgraph", "hub_selfloops"]
WIDTHS = [1, 32, 40, 128]
DTYPES = [torch.float32, torch.bfloat16]


def _close(got, want, scale):
    """|got - want| <= 1e-4 + 1e-4 * scale, plus bf16's rounding of each."""
    slack = _build.rounding_slack(got, want)
    return ((got.float() - want.float()).abs() <= 1e-4 + 1e-4 * scale.float() + slack).all()


def _randn(shape, gen, device, dtype):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


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
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.dirname(kernel._SRC).endswith(os.path.join("gala_tpu_torch", "csrc"))
    with open(attn_bell._SRC) as f:
        src = f.read()
    for name in ("attn_fwd_planned", "attn_bwd1_planned", "attn_bwd2_planned"):
        assert name in src
    assert os.path.dirname(attn_bell._SRC) == os.path.dirname(kernel._SRC)
    with open(sddmm._SRC) as f:
        src = f.read()
    assert "gala_tpu/ops/pallas/sddmm.py::sddmm_planned" in src
    assert os.path.dirname(sddmm._SRC) == os.path.dirname(kernel._SRC)
    with open(gather._SRC) as f:
        src = f.read()
    assert "gala_tpu/ops/pallas/gather.py::gather_rows" in src
    assert os.path.dirname(gather._SRC) == os.path.dirname(kernel._SRC)
    with open(os.path.join(_build.CSRC_DIR, "probe.cu")) as f:
        assert "gala_tpu/ops/pallas/__init__.py::mosaic_available" in f.read()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version_on_the_card(cuda, case, f, dtype):
    """|kernel - plain| <= 1e-4 + 1e-4 * (|A| @ |x|) per element, in f32:
    the two sum a row's slots in different orders, and a sum's rounding
    error grows with the magnitudes of its terms, not with the result
    (the case graphs' values are positive, so |A| = A); at bf16 plus one
    unit in the last place of the rounded result.  Two calls bitwise
    equal."""
    host, undirected = torch_case(case)
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = _randn((g.c_pad, f), gen, cuda, dtype)
    dz = _randn((g.n_pad, f), gen, cuda, dtype)
    counts = _build.dtype_counts("bell_spmm", dtype)
    for lay, inp, n_out in ((g.bell, x, g.n_pad), (g.t_bell, dz, g.c_pad)):
        launches = counts.launches
        out = kernel.bell_spmm(lay, inp, n_out)
        torch.cuda.synchronize()
        assert counts.launches == launches + 1 and out.dtype == dtype
        ref = kernel.bell_spmm_reference(lay, inp, n_out)
        scale = kernel.bell_spmm_reference(lay, inp.abs(), n_out)
        assert _close(out, ref, scale)
        assert torch.equal(out, kernel.bell_spmm(lay, inp, n_out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_custom_ops_are_the_direct_launches_on_the_card(cuda, case, dtype):
    """The custom ops of ops.kernels.library on CUDA tensors, bitwise the
    kernels' bindings they call, one launch a call and no plain version: the
    SpMM forward and its registered gradient on the transpose, with
    per-slot values on the ELL layout, the SDDMM, the attention forward
    (with and without the flash statistics) and bwd2."""
    from gala_tpu_torch.ops.kernels import library

    host, undirected = torch_case(case)
    bell = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda,
                           attention=True)
    ell = Graph.from_host(host, strategy="ell", undirected=undirected, device=cuda,
                          edge_vals=True)
    gen = torch.Generator(device=cuda).manual_seed(17)
    _build.reset_counts()
    x = _randn((bell.c_pad, 32), gen, cuda, dtype).requires_grad_(True)
    dz = _randn((bell.n_pad, 32), gen, cuda, dtype)
    out = library.spmm(x, bell.bell, bell.t_bell, bell.n_pad, bell.c_pad)
    out.backward(dz)
    assert torch.equal(out, kernel.bell_spmm(bell.bell, x.detach(), bell.n_pad))
    assert torch.equal(x.grad, kernel.bell_spmm(bell.t_bell, dz, bell.c_pad))

    xe = _randn((ell.c_pad, 40), gen, cuda, dtype)
    vals = torch.rand(ell.ell.flat_vals.shape, generator=gen, device=cuda)
    assert torch.equal(library.bell_spmm_op(xe, *library.layout_args(ell.ell), vals, ell.n_pad,
                                            [], [], 0),
                       kernel.bell_spmm(ell.ell, xe, ell.n_pad, vals))
    a, b = _randn((ell.c_pad, 40), gen, cuda, dtype), _randn((ell.n_pad, 40), gen, cuda, dtype)
    assert torch.equal(library.sddmm_op(ell.src, ell.dst, a, b),
                       sddmm.sddmm(ell.src, ell.dst, a, b))

    vl, vr = _randn((bell.c_pad, 1), gen, cuda, dtype), _randn((bell.n_pad, 1), gen, cuda, dtype)
    lay, t_lay = library.layout_args(bell.attn.fwd), library.layout_args(bell.attn.t)
    for flash in (True, False):
        got = library.attn_fwd_op(x.detach(), vl, vr, *lay, *t_lay, 0.2, bell.n_pad,
                                  bell.c_pad, flash)
        want = attn_bell.attn_fwd(bell.attn.fwd, x.detach(), vl, vr, 0.2, bell.n_pad, flash)
        assert all(torch.equal(g, w) for g, w in zip(got, want) if w is not None)
    w_tab = torch.cat([dz.float(), vr.float(), got[1], got[2], dz[:, :1].float()], dim=1)
    assert torch.equal(library.attn_bwd2_op(x.detach(), vl, w_tab, *t_lay, 0.2, bell.c_pad),
                       attn_bell.attn_bwd2(bell.attn.t, x.detach(), vl, w_tab, 0.2, bell.c_pad))
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in _build.all_counts().items() if c.launches}
    on_cuda = {n: c.reference_calls_on_cuda for n, c in _build.all_counts().items()
               if c.reference_calls_on_cuda}
    suffix = "" if dtype == torch.float32 else "_bf16"
    assert launches == {f"bell_spmm{suffix}": 6, f"sddmm{suffix}": 2, f"attn_fwd{suffix}": 4,
                        f"attn_bwd2{suffix}": 2}
    assert on_cuda == {}


L = UNIT_SLOTS
LONG_ROWS = [L - 1, L, L + 1, 2 * L, 52 * L]


def long_row_host(length: int, seed=3):
    """Directed graph on 7,000 nodes: node 0 has in-degree `length`, node
    1 out-degree `length` (a long row of the transpose), 20,000 random
    edges among the others, self-loops on every third of those, the last
    300 nodes isolated."""
    rng = np.random.default_rng(seed)
    n, m = 7000, 6700
    src = np.concatenate([rng.integers(2, m, 20000), rng.integers(2, m, length),
                          np.full(length, 1), np.arange(3, m, 3)])
    dst = np.concatenate([rng.integers(2, m, 20000), np.zeros(length, np.int64),
                          rng.integers(2, m, length), np.arange(3, m, 3)])
    vals = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
    return tcsr.coo_to_csr(src, dst, vals, n_rows=n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 32, 33, 128, 132])
@pytest.mark.parametrize("length", LONG_ROWS)
def test_kernel_on_long_rows_matches_plain_version(cuda, length, f, dtype):
    """Rows of L-1 .. 52L slots on the edge-list layout (a row is exactly
    its degree) and the binned one, each way: split into units, merged in
    order; F = 132 takes two blockIdx.y slices, F = 33 scalar loads."""
    host = long_row_host(length)
    gen = torch.Generator(device=cuda).manual_seed(length + f)
    for strategy in ("segment", "bell"):
        g = Graph.from_host(host, strategy=strategy, device=cuda, edge_vals=strategy != "bell")
        fwd, bwd = (g.seg, g.t_seg) if strategy == "segment" else (g.bell, g.t_bell)
        if strategy == "segment":
            assert int(fwd.row_len[0]) == int(bwd.row_len[1]) == length
        for lay, rows, n_out in ((fwd, g.c_pad, g.n_pad), (bwd, g.n_pad, g.c_pad)):
            x = _randn((rows, f), gen, cuda, dtype)
            counts = _build.dtype_counts("bell_spmm", dtype)
            launches = counts.launches
            out = kernel.bell_spmm(lay, x, n_out)
            torch.cuda.synchronize()
            assert counts.launches == launches + 1
            ref = kernel.bell_spmm_rows_reference(lay, x, n_out)
            scale = kernel.bell_spmm_rows_reference(lay, x.abs(), n_out)
            assert _close(out, ref, scale)
            assert _close(kernel.bell_spmm_units_reference(lay, x, n_out), ref, scale)
            assert torch.equal(out, kernel.bell_spmm(lay, x, n_out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hf,nh", [(32, 1), (40, 1), (41, 1), (32, 4), (192, 2)])
@pytest.mark.parametrize("length", LONG_ROWS)
def test_attention_forward_on_long_rows_and_masked_units(cuda, length, hf, nh, dtype):
    """The forward and bwd1 kernels against their plain versions and
    their units emulations on rows of L-1 .. 52L slots, as built and with
    all-masked units and a wholly masked split row (bwd1 under the
    forward's (m, s) on that layout); two calls bitwise equal; bwd2
    against its plain version as before.  hf = 192 at 2 heads: 48 4-column
    vectors, two 32-vector slices, head 1 straddling them (bwd1 sums its
    dots over both); hf = 41 at its row pitch (44 columns; 48 in the bf16
    forward, whose lanes load 16 bytes)."""
    host = long_row_host(length)
    g = Graph.from_host(host, strategy="bell", device=cuda, attention=True)
    gen = torch.Generator(device=cuda).manual_seed(length * 10 + hf + nh)
    rand = lambda *shape: _randn(shape, gen, cuda, dtype)  # noqa: E731
    x, vl, vr, dout = rand(g.c_pad, hf), rand(g.c_pad, nh), rand(g.n_pad, nh), rand(g.n_pad, hf)
    res = attn_bell.compare_with_plain(g.attn, x, vl, vr, dout, 0.2, g.n_pad, g.c_pad)
    assert {k: v for k, v in res.items() if v[1]} == {}
    for lay in (g.attn.fwd, masked_units(g.attn.fwd)):
        got = attn_bell.attn_fwd(lay, x, vl, vr, 0.2, g.n_pad, True)
        again = attn_bell.attn_fwd(lay, x, vl, vr, 0.2, g.n_pad, True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(torch.isfinite(t).all() for t in got)
        scale = attn_bell.attn_fwd_reference(lay, x.abs(), vl, vr, 0.2, g.n_pad, True)
        for want in (attn_bell.attn_fwd_reference(lay, x, vl, vr, 0.2, g.n_pad, True),
                     attn_bell.attn_fwd_units_reference(lay, x, vl, vr, 0.2, g.n_pad, True)):
            for a, b, sc in zip(got, want, (scale[0], 0.0, want[2], scale[3], want[4])):
                assert ((a - b).abs() <= 1e-4 + 1e-4 * sc).all()
        args = (lay, x, vl, vr, dout, got[1], got[2], 0.2)
        counts = _build.dtype_counts("attn_bwd1", dtype)
        launches = counts.launches
        b1 = torch.cat(attn_bell.attn_bwd1(*args), dim=1)
        again = torch.cat(attn_bell.attn_bwd1(*args), dim=1)
        torch.cuda.synchronize()
        assert counts.launches == launches + 2
        assert torch.equal(b1, again) and torch.isfinite(b1).all()
        a_sds, _, a_b = attn_bell.attn_bwd1_reference(lay, x.abs(), vl, vr, dout.abs(),
                                                      *args[5:])
        scale = torch.cat([a_sds, a_sds, a_b], dim=1)
        for want in (attn_bell.attn_bwd1_reference(*args),
                     attn_bell.attn_bwd1_units_reference(*args)):
            assert ((b1 - torch.cat(want, dim=1)).abs() <= 1e-4 + 1e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("every", [1, 3])
def test_rows_no_unit_writes_are_zero_over_stale_memory(cuda, every, dtype):
    """The SpMM, the forward, bwd1 (fwd layout) and bwd2 (transpose
    layout) zero only the output rows from WorkUnits.n_written on.  Over
    memory the allocator last held full of NaN, every row that no unit
    writes (padding, and the rows left out when only every `every`-th
    descriptor row is kept) is 0 and finite, and the rest are the units
    emulation's (the plain version reads the bins, which select_rows
    leaves whole), within 1e-4 + 1e-4 * the emulation on magnitudes."""
    host, undirected = torch_case("hub_selfloops")
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda,
                        attention=True)
    keep = np.arange(g.bell.row_len.shape[0]) % every == 0
    bell = select_rows(g.bell, keep)
    fwd = select_rows(g.attn.fwd, np.arange(g.attn.fwd.row_len.shape[0]) % every == 0)
    assert bell.units.n_written <= g.n_pad
    assert (every == 1) == (bell.units.n_written == g.bell.n_real)
    gen = torch.Generator(device=cuda).manual_seed(every)
    x, vl, vr = (_randn(shape, gen, cuda, dtype) for shape in ((g.c_pad, 32), (g.c_pad, 1),
                                                               (g.n_pad, 1)))

    def stale(call):
        torch.cuda.synchronize()
        torch.full((64 << 20,), float("nan"), device=cuda)  # freed, then handed back
        return call()

    out = stale(lambda: kernel.bell_spmm(bell, x, g.n_pad))
    written = torch.zeros(g.n_pad, dtype=torch.bool, device=cuda)
    written[bell.row_node.long()] = True
    assert (out[~written] == 0).all() and torch.isfinite(out).all()
    assert _close(out, kernel.bell_spmm_units_reference(bell, x, g.n_pad),
                  kernel.bell_spmm_units_reference(bell, x.abs(), g.n_pad))
    got = stale(lambda: attn_bell.attn_fwd(fwd, x, vl, vr, 0.2, g.n_pad, True))
    want = attn_bell.attn_fwd_units_reference(fwd, x, vl, vr, 0.2, g.n_pad, True)
    scale = attn_bell.attn_fwd_units_reference(fwd, x.abs(), vl, vr, 0.2, g.n_pad, True)
    written = torch.zeros(g.n_pad, dtype=torch.bool, device=cuda)
    written[fwd.row_node.long()] = True
    for a, b, sc in zip(got, want, (scale[0], 0.0, want[2], scale[3], want[4])):
        assert (a[~written] == 0).all() and torch.isfinite(a).all()
        assert ((a - b).abs() <= 1e-4 + 1e-4 * sc).all()

    dout = _randn((g.n_pad, 32), gen, cuda, dtype)
    _, m, s, _, _ = attn_bell.attn_fwd_reference(g.attn.fwd, x, vl, vr, 0.2, g.n_pad, True)
    got = torch.cat(stale(lambda: attn_bell.attn_bwd1(fwd, x, vl, vr, dout, m, s, 0.2)), dim=1)
    want = torch.cat(attn_bell.attn_bwd1_units_reference(fwd, x, vl, vr, dout, m, s, 0.2), dim=1)
    a_sds, _, a_b = attn_bell.attn_bwd1_units_reference(fwd, x.abs(), vl, vr, dout.abs(), m, s,
                                                        0.2)
    assert (got[~written] == 0).all() and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-4 + 1e-4 * torch.cat([a_sds, a_sds, a_b], dim=1)).all()
    t = select_rows(g.attn.t, np.arange(g.attn.t.row_len.shape[0]) % every == 0)
    assert t.units.n_written <= g.c_pad
    x, vl, w_tab = bwd2_inputs(g, 32, 1, gen, dtype)
    a_tab = torch.cat([w_tab[:, :32].abs(), w_tab[:, 32:35], -w_tab[:, 35:].abs()], dim=1)
    got = stale(lambda: attn_bell.attn_bwd2(t, x, vl, w_tab, 0.2, g.c_pad))
    want = attn_bell.attn_bwd2_units_reference(t, x, vl, w_tab, 0.2, g.c_pad)
    scale = attn_bell.attn_bwd2_units_reference(t, x.abs(), vl, a_tab, 0.2, g.c_pad)
    written = torch.zeros(g.c_pad, dtype=torch.bool, device=cuda)
    written[t.row_node.long()] = True
    assert (got[~written] == 0).all() and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-4 + 1e-4 * scale).all()


BWD2_ROWS = [L + 1, 1000, 52 * L]  # transpose rows of 2, 8 and 52 units
BWD2_SHAPES = [(32, 1), (40, 1), (33, 1), (41, 1), (32, 4), (32, 8), (40, 8), (192, 2)]  # (hf, H)


def bwd2_inputs(g, hf, nh, gen, dtype=torch.float32):
    """x, vl (in `dtype`) and an f32 destination table [dout | vr | m | s |
    sds] drawn on the card (pass 2 is a function of the table alone), as
    attn_bell.bwd2_table builds it."""
    rand = lambda *shape: torch.randn(shape, generator=gen, device=g.device)  # noqa: E731
    s = torch.rand((g.n_pad, nh), generator=gen, device=g.device) * 1.5 + 0.5
    dout, vr, m, sds = rand(g.n_pad, hf), rand(g.n_pad, nh), rand(g.n_pad, nh), rand(g.n_pad, nh)
    x, vl = rand(g.c_pad, hf).to(dtype), rand(g.c_pad, nh).to(dtype)
    return x, vl, attn_bell.bwd2_table(x, dout, vr, m, s, sds)


def abs_table(w_tab, nh):
    """bwd2's table with |dout| and -|sds| (at its pitch): the plain version
    on it gives the magnitudes of the summed terms."""
    d = w_tab.shape[1] - 4 * nh
    return torch.cat([w_tab[:, :d].abs(), w_tab[:, d : d + 3 * nh],
                      -w_tab[:, d + 3 * nh :].abs()], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hf,nh", BWD2_SHAPES)
@pytest.mark.parametrize("length", BWD2_ROWS)
def test_bwd2_over_units_matches_plain_versions(cuda, length, hf, nh, dtype):
    """bwd2 over the transpose layout's work units against attn_bwd2_reference
    and attn_bwd2_units_reference, on a source row of `length` slots as
    built and with masked units; one head, 2, 4 and 8 (fh 33, 41 and 5 run
    at their row pitch, 36, 44 and 8 columns, as 4-column vectors; fh 96
    at 2 heads two slices of 4-column vectors, head 1 straddling them);
    two calls
    bitwise equal; one launch counted per call.  Tolerance 1e-4 + 1e-4 *
    the plain version on magnitudes, as compare_with_plain takes it."""
    g = Graph.from_host(long_row_host(length), strategy="bell", device=cuda, attention=True)
    assert int(g.attn.t.row_len.max()) >= length and g.attn.t.units.n_partials
    gen = torch.Generator(device=cuda).manual_seed(length + hf * 10 + nh)
    x, vl, w_tab = bwd2_inputs(g, hf, nh, gen, dtype)
    a_tab = abs_table(w_tab, nh)
    counts = _build.dtype_counts("attn_bwd2", dtype)
    for lay in (g.attn.t, masked_units(g.attn.t)):
        launches = counts.launches
        got = attn_bell.attn_bwd2(lay, x, vl, w_tab, 0.2, g.c_pad)
        again = attn_bell.attn_bwd2(lay, x, vl, w_tab, 0.2, g.c_pad)
        torch.cuda.synchronize()
        assert counts.launches == launches + 2
        assert torch.equal(got, again) and torch.isfinite(got).all()
        scale = attn_bell.attn_bwd2_reference(lay, x.abs(), vl, a_tab, 0.2, g.c_pad)
        for want in (attn_bell.attn_bwd2_reference(lay, x, vl, w_tab, 0.2, g.c_pad),
                     attn_bell.attn_bwd2_units_reference(lay, x, vl, w_tab, 0.2, g.c_pad)):
            assert ((got - want).abs() <= 1e-4 + 1e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hf", [64, 328])
def test_bwd2_on_a_shared_dout_block_equals_the_per_head_table(cuda, hf, dtype):
    """The gradient of a mean over 8 heads (gat_heads(8, out=8)'s layers: 8
    of 8, 8 of 41 at pitch 44): bwd2 on bwd2_table's shared form, one dout
    block that every head's lanes read, against bwd2 on the per-head table
    that repeats it, on the same inputs: bitwise equal (the same values
    summed in the same order), both attn_bwd2_kernel<4, 8, ...>.  Every
    third source row of the transpose layout kept, over memory the
    allocator last held full of NaN: the rows no unit writes are 0."""
    nh, fh = 8, hf // 8
    host, undirected = torch_case("hub_selfloops")
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda,
                        attention=True)
    t = select_rows(g.attn.t, np.arange(g.attn.t.row_len.shape[0]) % 3 == 0)
    gen = torch.Generator(device=cuda).manual_seed(hf)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=cuda)  # noqa: E731
    x, vl = rand(g.c_pad, hf).to(dtype), rand(g.c_pad, nh).to(dtype)
    vr, m, out = rand(g.n_pad, nh), rand(g.n_pad, nh), rand(g.n_pad, hf)
    s = torch.rand((g.n_pad, nh), generator=gen, device=cuda) + 0.5
    one = rand(g.n_pad, fh) / nh  # a mean's dout / H
    sds = attn_bell.per_head_dot(one, out, nh)
    shared = attn_bell.bwd2_table(x, one, vr, m, s, sds)
    per_head = attn_bell.bwd2_table(x, one.repeat(1, nh), vr, m, s, sds)
    assert shared.shape[1] == attn_bell.row_pitch(fh) + 4 * nh

    def stale(w_tab):
        torch.cuda.synchronize()
        torch.full((64 << 20,), float("nan"), device=cuda)  # freed, then handed back
        return attn_bell.attn_bwd2(t, x, vl, w_tab, 0.2, g.c_pad)

    got, want = stale(shared), stale(per_head)
    written = torch.zeros(g.c_pad, dtype=torch.bool, device=cuda)
    written[t.row_node.long()] = True
    assert (got[~written] == 0).all() and torch.isfinite(got).all()
    assert torch.equal(got, want)
    names = _device_kernels(lambda: attn_bell.attn_bwd2(t, x, vl, shared, 0.2, g.c_pad))
    assert any("attn_bwd2_kernel<4, 8," in n for n in names), names


FAR = 2**31  # slots before a shifted layout's own: every unit start past 2^31


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_unit_kernels_read_starts_past_2_31(cuda, dtype):
    """The SpMM and the three attention kernels on layouts whose slots lie
    after 2^31 unused ones (ops.graph.shifted_slots: ~17 GB a layout),
    against the same kernels on the layout itself, bitwise (the same sums
    in the same order); the layout itself is held to the plain versions by
    the tests above."""
    g = Graph.from_host(torch_case("hub_selfloops")[0], strategy="bell", device=cuda,
                        attention=True)
    gen = torch.Generator(device=cuda).manual_seed(31)
    rand = lambda *shape: _randn(shape, gen, cuda, dtype)  # noqa: E731
    for lay, rows, n_out in ((g.bell, g.c_pad, g.n_pad), (g.t_bell, g.n_pad, g.c_pad)):
        x = rand(rows, 32)
        far = shifted_slots(lay, FAR)
        assert int(far.units.start.min()) >= FAR
        assert torch.equal(kernel.bell_spmm(far, x, n_out), kernel.bell_spmm(lay, x, n_out))
        del far
    x, vl, vr, dout = rand(g.c_pad, 32), rand(g.c_pad, 1), rand(g.n_pad, 1), rand(g.n_pad, 32)
    far = shifted_slots(g.attn.fwd, FAR)
    fwd = attn_bell.attn_fwd(g.attn.fwd, x, vl, vr, 0.2, g.n_pad, True)
    assert all(torch.equal(a, b) for a, b in
               zip(attn_bell.attn_fwd(far, x, vl, vr, 0.2, g.n_pad, True), fwd))
    args = (x, vl, vr, dout, fwd[1], fwd[2], 0.2)
    assert all(torch.equal(a, b) for a, b in zip(attn_bell.attn_bwd1(far, *args),
                                                 attn_bell.attn_bwd1(g.attn.fwd, *args)))
    del far
    w_tab = torch.cat([dout.float(), vr.float(), fwd[1], fwd[2],
                       attn_bell.per_head_dot(dout, fwd[0], 1)], dim=1)
    far = shifted_slots(g.attn.t, FAR)
    assert torch.equal(attn_bell.attn_bwd2(far, x, vl, w_tab, 0.2, g.c_pad),
                       attn_bell.attn_bwd2(g.attn.t, x, vl, w_tab, 0.2, g.c_pad))
    del far
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_unit_kernels_on_column_tiled_layouts(cuda, case, dtype):
    """col_tile: every layout's units cut at column tiles of 64 (rows split
    into more partials) and run tile-major; the SpMM and the attention
    kernels against their plain versions with the tolerances above."""
    host, undirected = torch_case(case)
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda,
                        attention=True, col_tile=64)
    gen = torch.Generator(device=cuda).manual_seed(64)
    for lay, rows, n_out in ((g.bell, g.c_pad, g.n_pad), (g.t_bell, g.n_pad, g.c_pad)):
        assert lay.units.n_partials
        x = _randn((rows, 32), gen, cuda, dtype)
        out = kernel.bell_spmm(lay, x, n_out)
        ref = kernel.bell_spmm_rows_reference(lay, x, n_out)
        assert _close(out, ref, kernel.bell_spmm_rows_reference(lay, x.abs(), n_out))
    rand = lambda *shape: _randn(shape, gen, cuda, dtype)  # noqa: E731
    res = attn_bell.compare_with_plain(g.attn, rand(g.c_pad, 32), rand(g.c_pad, 1),
                                       rand(g.n_pad, 1), rand(g.n_pad, 32), 0.2, g.n_pad, g.c_pad)
    assert {k: v for k, v in res.items() if v[1]} == {}


@pytest.mark.cuda
def test_launch_limits_are_readable(cuda):
    """Registers, shared memory and resident blocks of the unit kernels:
    every pass-1 kernel fits at least one block of 8 warps on an SM."""
    for name, lim in {**kernel.launch_limits(), **attn_bell.launch_limits(8)}.items():
        assert lim["blocks_per_sm"] >= 1 and 0 < lim["registers"] <= 255, (name, lim)


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


# (hf, H); fh 41, 10 and 7 run at their row pitch (44, 12 and 8; 48, 16 and 8 in
# the bf16 forward)
ATTN_SHAPES = [(32, 1), (40, 1), (41, 1), (32, 4), (40, 4), (21, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hf,nh", ATTN_SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_attention_kernels_match_plain_versions_on_the_card(cuda, case, hf, nh, dtype):
    """fwd, bwd1 and bwd2 against their plain versions and bwd1 against the
    flash identity, with attn_bell.compare_with_plain's per-element
    tolerance (1e-4 + 1e-4 * the magnitudes of the summed terms), and two
    calls of each bitwise equal."""
    host, undirected = torch_case(case)
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda,
                        attention=True)
    gen = torch.Generator(device=cuda).manual_seed(hf * 10 + nh)
    rand = lambda *shape: _randn(shape, gen, cuda, dtype)  # noqa: E731
    x, vl, vr, dout = rand(g.c_pad, hf), rand(g.c_pad, nh), rand(g.n_pad, nh), rand(g.n_pad, hf)
    counts = {n: _build.dtype_counts(n, dtype) for n in attn_bell.NAMES}
    before = {n: c.launches for n, c in counts.items()}
    res = attn_bell.compare_with_plain(g.attn, x, vl, vr, dout, 0.2, g.n_pad, g.c_pad)
    torch.cuda.synchronize()
    assert all(c.launches == before[n] + 1 for n, c in counts.items())
    assert {k: v for k, v in res.items() if v[1]} == {}
    out, m, s, _, _ = attn_bell.attn_fwd(g.attn.fwd, x, vl, vr, 0.2, g.n_pad, True)
    w_tab = attn_bell.bwd2_table(x, dout, vr, m, s, attn_bell.per_head_dot(dout, out, nh))
    for call in (lambda: attn_bell.attn_fwd(g.attn.fwd, x, vl, vr, 0.2, g.n_pad, True),
                 lambda: attn_bell.attn_bwd1(g.attn.fwd, x, vl, vr, dout, m, s, 0.2),
                 lambda: (attn_bell.attn_bwd2(g.attn.t, x, vl, w_tab, 0.2, g.c_pad),)):
        assert all(torch.equal(a, b) for a, b in zip(call(), call()))


# the indices of hf, H, vec and log2_g among the forward's and bwd2's C arguments
LANE_ARGS = {"attn_fwd": (24, 25, 27, 28), "attn_bwd2": (19, 20, 22, 23)}


def record_launches(monkeypatch, launch=None) -> list:
    """Record what each attention forward and bwd2 launch receives:
    (kernel, (launch width hf, heads, slices its warps walk: hf / vec
    vectors in slices of 2^log2_g lanes)) appended to the list returned;
    every launch then goes on to `launch` (the real one on the card;
    None leaves it out, on CPU tensors)."""
    launched = []

    def spy(lib, name, t, *args, **kw):
        if name in LANE_ARGS:
            i_hf, i_nh, i_vec, i_log2 = LANE_ARGS[name]
            launched.append((name, (args[i_hf], args[i_nh],
                                    -(-(args[i_hf] // args[i_vec]) // (1 << args[i_log2])))))
        if launch is not None:
            launch(lib, name, t, *args, **kw)

    monkeypatch.setattr(attn_bell, "launch", spy)
    return launched


def _device_kernels(fn) -> list[str]:
    """The names of the device kernels that fn() launches (torch.profiler's
    CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type.name == "CUDA"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hf,nh", [(41, 1), (21, 3)])
def test_pitched_attention_runs_16_byte_lanes_and_backpropagates(cuda, monkeypatch, hf, nh,
                                                                  dtype):
    """attention_aggregate forward and backward at heads of 41 and 7
    columns, which run at their row pitch: out and the gradients of x, vl
    and vr against the same op on CPU copies (the plain versions) within
    1e-4 + 1e-4 * the magnitudes of the summed terms
    (attn_bell.aggregate_scales) and one bf16 unit where the result is
    bf16; the forward launches its 16-byte form (attn_fwd_kernel<4> at
    f32, <8> at bf16) and bwd2 its 4-column one, each launched once at
    its own pitched width H * row_pitch(fh), and at H heads (the
    multi-head forms at 3)."""
    from gala_tpu_torch.ops.attention import attention_aggregate

    host, undirected = torch_case("hub_selfloops")
    g = Graph.from_host(host, strategy="bell", undirected=undirected, device=cuda,
                        attention=True)
    g_cpu = Graph.from_host(host, strategy="bell", undirected=undirected, device="cpu",
                            attention=True)
    gen = torch.Generator(device=cuda).manual_seed(hf + nh)
    inputs = [_randn(shape, gen, cuda, dtype) for shape in
              ((g.c_pad, hf), (g.c_pad, nh), (g.n_pad, nh), (g.n_pad, hf))]
    dout = inputs.pop()
    results = []
    for graph, dev in ((g, cuda), (g_cpu, "cpu")):
        x, vl, vr = (t.detach().to(dev).requires_grad_(True) for t in inputs)
        out = attention_aggregate(graph.n_pad, graph.c_pad, 0.2, graph.attn, x, vl, vr)
        out.backward(dout.to(dev))
        results.append([t.cpu() for t in (out.detach(), x.grad, vl.grad, vr.grad)])
    scales = attn_bell.aggregate_scales(g_cpu.attn, *(t.cpu() for t in inputs), dout.cpu(), 0.2,
                                        g.n_pad, g.c_pad)
    for got, want, scale in zip(*results, scales):
        assert got.shape == want.shape and _close(got, want, scale)

    x, vl, vr = (t.clone().requires_grad_(True) for t in inputs)
    launched = record_launches(monkeypatch, _build.launch)
    names = [n for n in _device_kernels(
        lambda: attention_aggregate(g.n_pad, g.c_pad, 0.2, g.attn, x, vl, vr).backward(dout))
        if "attn_" in n]
    lane = 16 // dtype.itemsize
    assert any(f"attn_fwd_kernel<{lane}," in n for n in names), names
    assert any("attn_bwd2_kernel<4," in n for n in names), names
    fh = hf // nh
    assert [(name, lanes[:2]) for name, lanes in launched] == [
        ("attn_fwd", (nh * attn_bell.row_pitch(fh, lane), nh)),
        ("attn_bwd2", (nh * attn_bell.row_pitch(fh), nh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh,fh", [(8, 8), (8, 41), (6, 8), (2, 8)])
def test_attention_aggregate_at_eight_heads_matches_plain_version(cuda, monkeypatch, nh, fh,
                                                                   dtype):
    """The attention kernels' multi-head forms at the GAT paper's 8 heads
    (8 of 8, and 8 of 41: pitch 44, 352 columns at f32, 3 slices walked
    in the warp), at 6 heads (not a power of two: the lanes past them
    idle) and at 2, on the hub graph: fwd, bwd1 and bwd2 against their
    plain versions (attn_bell.compare_with_plain's tolerance) and two calls
    of each bitwise equal; attention_aggregate forward and gradient, out
    and the gradients of x, vl and vr against the same op on CPU copies
    (the plain versions) within 1e-4 + 1e-4 * the magnitudes of the summed
    terms (attn_bell.aggregate_scales); the aggregate launches the
    forward's and bwd2's multi-head forms once each, at H heads, with
    lanes vec and log2_g that give the g-vector slices its warps walk."""
    from gala_tpu_torch.ops.attention import attention_aggregate

    host, undirected = torch_case("hub_selfloops")
    graphs = [Graph.from_host(host, strategy="bell", undirected=undirected, device=dev,
                              attention=True) for dev in (cuda, "cpu")]
    g = graphs[0]
    hf = nh * fh
    gen = torch.Generator(device=cuda).manual_seed(hf)
    inputs = [_randn(shape, gen, cuda, dtype) for shape in
              ((g.c_pad, hf), (g.c_pad, nh), (g.n_pad, nh), (g.n_pad, hf))]
    dout = inputs.pop()
    res = attn_bell.compare_with_plain(g.attn, *inputs, dout, 0.2, g.n_pad, g.c_pad)
    assert {k: v for k, v in res.items() if v[1]} == {}
    x, vl, vr = inputs
    out, m, s, _, _ = attn_bell.attn_fwd(g.attn.fwd, x, vl, vr, 0.2, g.n_pad, True)
    w_tab = attn_bell.bwd2_table(x, dout, vr, m, s, attn_bell.per_head_dot(dout, out, nh))
    for call in (lambda: attn_bell.attn_fwd(g.attn.fwd, x, vl, vr, 0.2, g.n_pad, True),
                 lambda: attn_bell.attn_bwd1(g.attn.fwd, x, vl, vr, dout, m, s, 0.2),
                 lambda: (attn_bell.attn_bwd2(g.attn.t, x, vl, w_tab, 0.2, g.c_pad),)):
        assert all(torch.equal(a, b) for a, b in zip(call(), call()))

    results = []
    for graph, dev in zip(graphs, (cuda, "cpu")):
        x, vl, vr = (t.detach().to(dev).requires_grad_(True) for t in inputs)
        out = attention_aggregate(graph.n_pad, graph.c_pad, 0.2, graph.attn, x, vl, vr)
        out.backward(dout.to(dev))
        results.append([t.cpu() for t in (out.detach(), x.grad, vl.grad, vr.grad)])
    scales = attn_bell.aggregate_scales(graphs[1].attn, *(t.cpu() for t in inputs), dout.cpu(),
                                        0.2, g.n_pad, g.c_pad)
    for got, want, scale in zip(*results, scales):
        assert got.shape == want.shape and _close(got, want, scale)

    x, vl, vr = (t.clone().requires_grad_(True) for t in inputs)
    launched = record_launches(monkeypatch, _build.launch)
    names = _device_kernels(
        lambda: attention_aggregate(g.n_pad, g.c_pad, 0.2, g.attn, x, vl, vr).backward(dout))
    # the forward's lanes: 16 bytes of x where a head's pitch holds them
    lane = 16 // dtype.itemsize
    vec = lane if attn_bell.row_pitch(fh, lane) % lane == 0 else 4
    assert any(f"attn_fwd_kernel<{vec}, 8," in n for n in names), names
    assert any("attn_bwd2_kernel<4, 8," in n for n in names), names
    # 8 heads of 41: 88 float4 vectors a row in 3 slices of 32 lanes (48
    # 8-column vectors at pitch 48 in the bf16 forward: 2); else one slice
    fwd_slices = (3 if dtype == torch.float32 else 2) if fh == 41 else 1
    assert [(name, lanes[1:]) for name, lanes in launched] == [
        ("attn_fwd", (nh, fwd_slices)), ("attn_bwd2", (nh, 3 if fh == 41 else 1))]


SDDMM_WIDTHS = [1, 3, 32, 33, 40, 128]  # ragged widths take scalar loads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", SDDMM_WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_sddmm_matches_plain_version_on_the_card(cuda, case, f, dtype):
    """Over the padded edge list, |kernel - plain| <= 1e-4 + 1e-4 *
    sum_f |a||b| per edge (the two sum a row in different orders), at
    bf16 plus one unit in the last place of the rounded dot."""
    host, undirected = torch_case(case)
    g = Graph.from_host(host, strategy="ell", undirected=undirected, device=cuda,
                        edge_vals=True)
    gen = torch.Generator(device=cuda).manual_seed(f)
    a = _randn((g.c_pad, f), gen, cuda, dtype)
    b = _randn((g.n_pad, f), gen, cuda, dtype)
    counts = _build.dtype_counts("sddmm", dtype)
    launches = counts.launches
    out = sddmm.sddmm(g.src, g.dst, a, b)
    torch.cuda.synchronize()
    assert counts.launches == launches + 1 and out.shape == (g.e_pad,) and out.dtype == dtype
    ref = sddmm.sddmm_reference(g.src, g.dst, a, b)
    assert _close(out, ref, sddmm.sddmm_reference(g.src, g.dst, a.abs(), b.abs()))
    assert torch.equal(out, sddmm.sddmm(g.src, g.dst, a, b))
    # an unaligned view of a takes the scalar path
    a2 = _randn((g.c_pad * f + 1,), gen, cuda, dtype)[1:].view(g.c_pad, f)
    out2 = sddmm.sddmm(g.src, g.dst, a2, b)
    ref2 = sddmm.sddmm_reference(g.src, g.dst, a2, b)
    assert _close(out2, ref2, sddmm.sddmm_reference(g.src, g.dst, a2.abs(), b.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 32, 40])
@pytest.mark.parametrize("case", CASES)
def test_kernel_with_slot_values_on_ell_matches_plain_version(cuda, case, f, dtype):
    """bell_spmm with learned per-slot values on the ELL layout and its
    transpose against the descriptor plain version (values >= 0, so the
    tolerance scale is the plain version on |x|)."""
    host, undirected = torch_case(case)
    g = Graph.from_host(host, strategy="ell", undirected=undirected, device=cuda,
                        edge_vals=True)
    gen = torch.Generator(device=cuda).manual_seed(100 + f)
    evals = torch.rand((g.e_pad,), generator=gen, device=cuda)
    x = _randn((g.c_pad, f), gen, cuda, dtype)
    dz = _randn((g.n_pad, f), gen, cuda, dtype)
    for lay, inp, n_out in ((g.ell, x, g.n_pad), (g.t_ell, dz, g.c_pad)):
        vals = lay.slot_values(evals)
        out = kernel.bell_spmm(lay, inp, n_out, vals=vals)
        torch.cuda.synchronize()
        ref = kernel.bell_spmm_rows_reference(lay, inp, n_out, vals)
        scale = kernel.bell_spmm_rows_reference(lay, inp.abs(), n_out, vals)
        assert _close(out, ref, scale)
        assert torch.equal(out, kernel.bell_spmm(lay, inp, n_out, vals=vals))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 32, 33, 40])
@pytest.mark.parametrize("length", [L + 1, 52 * L])
def test_sddmm_on_hub_edge_lists_is_repeatable(cuda, length, f, dtype):
    """The SDDMM over an edge list with a destination of `length` edges and
    a source of `length` edges: within 1e-4 + 1e-4 * sum_f |a||b| of the
    plain version, and two calls bitwise equal; then with an unaligned
    table (scalar loads) and unaligned, odd-length edge lists (the
    indices' scalar path and a ragged last run)."""
    g = Graph.from_host(long_row_host(length), strategy="segment", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(length + f)
    a = _randn((g.c_pad, f), gen, cuda, dtype)
    b = _randn((g.n_pad, f), gen, cuda, dtype)
    a2 = _randn((g.c_pad * f + 1,), gen, cuda, dtype)[1:].view(g.c_pad, f)
    for src, dst, av in ((g.src, g.dst, a), (g.src, g.dst, a2), (g.src[1:], g.dst[1:], a),
                         (g.src[3:-2], g.dst[3:-2], a2)):
        out = sddmm.sddmm(src, dst, av, b)
        again = sddmm.sddmm(src, dst, av, b)
        torch.cuda.synchronize()
        assert torch.equal(out, again) and out.shape == src.shape
        ref = sddmm.sddmm_reference(src, dst, av, b)
        assert _close(out, ref, sddmm.sddmm_reference(src, dst, av.abs(), b.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [8, 40, 128, 136])
@pytest.mark.parametrize("length", [L + 1, 52 * L])
def test_sddmm_16_byte_lanes_on_hub_edge_lists(cuda, length, f, dtype):
    """The SDDMM's 16-byte lanes (8 bf16 or 4 f32 elements; F = 136 at bf16
    is 17 vectors, at f32 34: two rounds) on an edge list with a
    destination of `length` edges, and with either operand one element
    off 16-byte alignment (lane_width 1): within 1e-4 + 1e-4 * sum_f
    |a||b| of the plain version plus bf16's rounding, two calls bitwise
    equal, one launch a call."""
    g = Graph.from_host(long_row_host(length), strategy="segment", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(length + 3 * f)
    a = _randn((g.c_pad, f), gen, cuda, dtype)
    b = _randn((g.n_pad, f), gen, cuda, dtype)
    a2 = _randn((g.c_pad * f + 1,), gen, cuda, dtype)[1:].view(g.c_pad, f)
    b2 = _randn((g.n_pad * f + 1,), gen, cuda, dtype)[1:].view(g.n_pad, f)
    assert sddmm.lane_width(a, b) == 16 // a.element_size()
    assert sddmm.lane_width(a2, b) == sddmm.lane_width(a, b2) == 1
    counts = _build.dtype_counts("sddmm", dtype)
    for av, bv in ((a, b), (a2, b), (a, b2)):
        launches = counts.launches
        out = sddmm.sddmm(g.src, g.dst, av, bv)
        again = sddmm.sddmm(g.src, g.dst, av, bv)
        torch.cuda.synchronize()
        assert counts.launches == launches + 2
        assert torch.equal(out, again) and out.dtype == dtype
        ref = sddmm.sddmm_reference(g.src, g.dst, av, bv)
        assert _close(out, ref, sddmm.sddmm_reference(g.src, g.dst, av.abs(), bv.abs()))


PROBE_SIZES = [1, 3, 16384, 2**20 + 3]


@pytest.mark.cuda
def test_toolchain_probe_passes_on_the_card(cuda):
    """The probe answers True, and its kernel equals x * 2 bit for bit at
    n = 1, 3, 16,384 and 2^20 + 3 (float4 stores and a ragged end) and on
    views one float in (scalar stores), one launch counted per call."""
    assert _build.toolchain_available() is True
    gen = torch.Generator(device=cuda).manual_seed(0)
    counts = _build.counts_for("toolchain_probe")
    for n in PROBE_SIZES:
        x = torch.randn((n + 1,), generator=gen, device=cuda)
        for v in (x[:n], x[1:]):
            launches = counts.launches
            out = _build.probe_x2(v)
            torch.cuda.synchronize()
            assert counts.launches == launches + 1
            assert out.shape == v.shape and torch.equal(out, v * 2.0)


@pytest.mark.parametrize("n", [0, 1, 3, 16384])
def test_probe_x2_takes_the_plain_product_on_cpu_tensors(n):
    """On a CPU tensor probe_x2 is the plain product and records no
    launch."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
    counts = _build.counts_for("toolchain_probe")
    launches = counts.launches
    assert torch.equal(_build.probe_x2(x), x * 2.0)
    assert counts.launches == launches


@pytest.mark.cuda
def test_memory_field_is_each_models_live_memory(cuda):
    """memMB (print_memory) is the live allocation at the warm-up
    boundary: a small model compiled after a large one in the same
    process reports far less than the large one's peak, which the field
    (a peak reading) used to carry over.  What outlives a model is
    cuBLAS's workspaces alone (one per thread that ran a matmul: the
    forward's and autograd's), which the small model's memMB includes as
    live memory: clearing them leaves not a byte of either model."""
    import gc

    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.api import compile_model
    from gala_tpu_torch.dsl.parser import parse_source

    def memory_mb(n, feats):
        data = tsyn.synthetic_dataset(n=n, avg_degree=8, n_feats=feats, n_classes=5, seed=1,
                                      undirected=True)
        spec = parse_source(GCN_DSL)
        spec.print_memory = True
        cm = compile_model(spec, data=data, device=cuda)
        return cm.train(iters=3, warmup=1).memory_mb

    def workspaces_mb():
        """What stays allocated after a model is gone, which clearing
        cuBLAS's workspaces frees to the byte."""
        gc.collect()
        live = torch.cuda.memory_allocated(cuda)
        torch._C._cuda_clearCublasWorkspaces()
        assert torch.cuda.memory_allocated(cuda) == base
        return (live - base) / 1e6

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated(cuda)  # what earlier tests keep
    torch.cuda.reset_peak_memory_stats(cuda)
    large = memory_mb(60000, 512) - base / 1e6
    peak = torch.cuda.max_memory_allocated(cuda) / 1e6 - base / 1e6
    assert workspaces_mb() > 0
    small = memory_mb(20000, 16) - base / 1e6  # above the dense gate: bell
    workspaces = workspaces_mb()
    assert 0 < small < large < peak
    assert small - workspaces < peak / 10


@pytest.mark.cuda
def test_sddmm_refuses_what_it_does_not_take(cuda):
    host, _ = torch_case("hub_selfloops")
    g = Graph.from_host(host, strategy="segment", device=cuda)
    a = torch.zeros((g.c_pad, 8), device=cuda)
    b = torch.zeros((g.n_pad, 8), device=cuda)
    with pytest.raises(TypeError):
        sddmm.sddmm(g.src, g.dst, a.half(), b)
    with pytest.raises(ValueError, match="width"):
        sddmm.sddmm(g.src, g.dst, a, torch.zeros((g.n_pad, 4), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        sddmm.sddmm(g.src, g.dst, torch.zeros((8, g.c_pad), device=cuda).t(), b)
    with pytest.raises(ValueError):
        sddmm.sddmm(g.src, g.dst, a.cpu(), b)


GATHER_SHAPES = [(1, 2049), (33, 2047), (128, 4096), (602, 512), (40, 1)]  # (F, M)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,m", GATHER_SHAPES)
def test_gather_matches_plain_version_bitwise_on_the_card(cuda, f, m, dtype):
    """A copy: the kernel equals index_select bit for bit, on random and
    sorted indices, aligned and unaligned (8-, 4- and 2-byte) rows."""
    gen = torch.Generator(device=cuda).manual_seed(f * 7 + m)
    x = torch.randn((3000, f), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, 3000, (m,), generator=gen, device=cuda, dtype=torch.int32)
    for ids in (idx, idx.sort().values):
        launches = gather.counts.launches
        assert gather.compare_with_plain(x, ids) == 0.0
        torch.cuda.synchronize()
        assert gather.counts.launches == launches + 1
    # a view starting one element in takes narrower vectors
    x2 = torch.randn((3000 * f + 1,), generator=gen, device=cuda).to(dtype)[1:].view(3000, f)
    assert gather.compare_with_plain(x2, idx) == 0.0


@pytest.mark.cuda
def test_gather_refuses_what_it_does_not_take_on_the_card(cuda):
    x = torch.zeros((10, 4), device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    assert gather.gather_rows(x, idx[:0]).shape == (0, 4)
    with pytest.raises(ValueError, match="gradient"):
        gather.gather_rows(x.clone().requires_grad_(True), idx)
    with pytest.raises(ValueError):
        gather.gather_rows(x, idx.cpu())
    with pytest.raises(TypeError):
        gather.gather_rows(x.half(), idx)


def test_dyn_weights_source_names_what_it_replaces():
    """The weights are computed in the SpMM's sampled staging: its source
    names the XLA weights it replaces and its bound, the sampled form's
    module (ops.kernels.bell_spmm, which keeps the plain weights) names
    gala_tpu's _dyn_counts and _dyn_reweight, and no weights module or
    source of a weights kernel of its own is left."""
    import importlib.util

    with open(kernel._SRC) as f:
        src = f.read()
    assert "gala_tpu/ops/spmm.py::_dyn_counts" in src and "3.35 TB/s" in src
    assert "gala_bell_spmm_dyn_f32" in src and "gala_bell_spmm_dyn_bf16" in src
    assert "_dyn_counts" in kernel.__doc__ and "_dyn_reweight" in kernel.__doc__
    assert callable(kernel.dyn_weights_reference)
    assert not os.path.exists(os.path.join(_build.CSRC_DIR, "dyn_weights.cu"))
    assert importlib.util.find_spec("gala_tpu_torch.ops.kernels.dyn_weights") is None


def _sampled_graphs(device, col_tile=None):
    """The hub case with dynamic sampling's inputs, on 'bell' (bins and
    hub virtual rows) and on 'segment' (the edge lists); with `col_tile`
    each row's slots grouped by column tile (units whose positions have
    gaps)."""
    host, _ = torch_case("hub_selfloops")
    return {s: Graph.from_host(host, strategy=s, device=device, dynamic_sample=True,
                               col_tile=col_tile) for s in ("bell", "segment")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,ra,rb", [(1, 5, 7), (20, 96, 96), (300, 17, 5)])
def test_dyn_weights_matches_plain_version_bitwise_on_the_card(cuda, k, ra, rb, dtype):
    """The sampled SpMM computes each weight (a count times one value) in
    its staging: the fused call equals the SpMM kernel run with the plain
    weights as its values bit for bit (the same weights, the same sums),
    with and without the structural values, on both sides of 'bell' and
    'segment', untiled and in column tiles of 150 (units whose positions
    have gaps), at F = 1, 32 and 33 (scalar and 16-byte lanes); one
    launch a call under bell_spmm_dyn, the only launch of the call."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    counts = _build.dtype_counts("bell_spmm_dyn", dtype)
    graphs = [g for tile in (None, 150) for g in _sampled_graphs(cuda, tile).items()]
    for strategy, g in graphs:
        sides = ((g.bell, g.dyn_f, g.c_pad, g.n_pad), (g.t_bell, g.dyn_t, g.n_pad, g.c_pad)) if (
            strategy == "bell") else ((g.seg, g.dyn_f, g.c_pad, g.n_pad),
                                      (g.t_seg, g.dyn_t, g.n_pad, g.c_pad))
        for lay, meta, rows, n_out in sides:
            for structural in (False, True):
                w = kernel.dyn_weights_reference(meta.deg, meta.pos, k, ra, rb,
                                                 lay.flat_vals if structural else None)
                for f in (1, 32, 33):
                    x = _randn((rows, f), gen, cuda, dtype)
                    total = sum(c.launches for c in _build.all_counts().values())
                    launches = counts.launches
                    got = kernel.bell_spmm_sampled(lay, x, n_out, meta, k, ra, rb, structural)
                    torch.cuda.synchronize()
                    assert counts.launches == launches + 1 and got.dtype == dtype
                    assert sum(c.launches for c in _build.all_counts().values()) == total + 1
                    assert torch.equal(got, kernel.bell_spmm(lay, x, n_out, vals=w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strategy", ["bell", "segment"])
def test_spmm_sampled_on_the_card_matches_cpu(cuda, strategy, dtype):
    """spmm_sampled forward and x-gradient on the card (the SpMM kernel's
    sampled form, forward and transpose: two launches, no weights kernel,
    no plain version) against the same call on CPU tensors: _close's
    tolerance over the sampled product on magnitudes."""
    from gala_tpu_torch.ops.spmm import spmm_sampled

    k, ra, rb = 20, 13, 2
    g_card, g_cpu = _sampled_graphs(cuda)[strategy], _sampled_graphs("cpu")[strategy]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((g_cpu.c_pad, 33), generator=gen).to(dtype)
    dz = torch.randn((g_cpu.n_pad, 33), generator=gen).to(dtype)
    results = {}
    for name, g in (("card", g_card), ("cpu", g_cpu)):
        _build.reset_counts()
        xt = x.to(g.device).requires_grad_(True)
        out = spmm_sampled(g, xt, k, ra, rb)
        out.backward(dz.to(g.device))
        results[name] = (out.detach().cpu(), xt.grad.cpu())
        if name == "card":
            torch.cuda.synchronize()
            launches = {n: c.launches for n, c in _build.all_counts().items() if c.launches}
            on_cuda = {n: c.reference_calls_on_cuda for n, c in _build.all_counts().items()
                       if c.reference_calls_on_cuda}
            assert launches == {_build.dtype_counts("bell_spmm_dyn", dtype).name: 2}
            assert on_cuda == {}
    lay, t_lay = (g_cpu.bell, g_cpu.t_bell) if strategy == "bell" else (g_cpu.seg, g_cpu.t_seg)
    for i, (lay_, meta, inp, n_out) in enumerate(((lay, g_cpu.dyn_f, x, g_cpu.n_pad),
                                                  (t_lay, g_cpu.dyn_t, dz, g_cpu.c_pad))):
        w = kernel.dyn_weights_reference(meta.deg, meta.pos, k, ra, rb,
                                         lay_.flat_vals if strategy == "bell" else None)
        scale = kernel.bell_spmm_rows_reference(lay_, inp.float().abs(), n_out, w)
        assert results["card"][i].dtype == dtype
        assert _close(results["card"][i], results["cpu"][i], scale)


def _compiled_gcn(device, strategy="bell"):
    """GCN_DSL on the 600-node synthetic graph at `strategy` on `device`."""
    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL

    return gala_tpu_torch.compile_source(GCN_DSL, mode="train", strategy=strategy,
                                         data=_synthetic(tsyn, True), device=device)


@pytest.mark.cuda
def test_pallas_bell_runs_the_bell_kernel_on_the_card(cuda):
    """strategy='pallas_bell' is 'bell': the same layout, training
    launches the SpMM kernel and no plain version, and from the same
    weights its logits are bitwise those of strategy='bell'."""
    pallas, bell = _compiled_gcn(cuda, "pallas_bell"), _compiled_gcn(cuda, "bell")
    assert pallas.full_graphs[0].strategy == "bell"
    assert torch.equal(pallas.full_graphs[0].bell.flat_cols, bell.full_graphs[0].bell.flat_cols)
    _build.reset_counts()
    pallas.train(iters=3, warmup=1)
    torch.cuda.synchronize()
    assert kernel.counts.launches > 0 and kernel.counts.reference_calls_on_cuda == 0
    params = pallas.make_params(0)
    with torch.no_grad():
        logits = [cm.forward(params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
                  for cm in (pallas, bell)]
    assert torch.equal(*logits)


@pytest.mark.cuda
def test_resumed_run_equals_an_unbroken_one_on_the_card(cuda, tmp_path):
    """10 epochs against 5 with checkpoint_path and 5 with resume_from
    (valid_step 5 keeps the graph schedule aligned): the losses and the
    final params agree at rtol 1e-4 (losses) and 1e-3 / atol 1e-5
    (params), since the row gathers' backward adds with atomics; the
    SpMM kernel launches in both segments and no plain version runs."""
    cm = _compiled_gcn(cuda)
    unbroken = cm.train(iters=10, warmup=1)
    ck = str(tmp_path / "ck.pt")
    segments = []
    for kw in ({"checkpoint_path": ck}, {"resume_from": ck}):
        _build.reset_counts()
        segments.append(cm.train(iters=5, warmup=1, **kw))
        torch.cuda.synchronize()
        assert kernel.counts.launches > 0 and kernel.counts.reference_calls_on_cuda == 0
    first, second = segments
    np.testing.assert_allclose(first.losses + second.losses, unbroken.losses, rtol=1e-4)
    want = dict(unbroken.params.named_parameters())
    for name, p in second.params.named_parameters():
        np.testing.assert_allclose(p.detach().cpu().numpy(), want[name].detach().cpu().numpy(),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_export_for_the_card_and_the_cpu_from_a_model_on_the_card(cuda, tmp_path):
    """export_compiled(platforms=("cuda", "cpu")) of a model on the card:
    the cpu program is exported from the layouts moved to the CPU
    (ops.graph.moved).  Loaded on each device, the card's forward is
    bitwise the live one and launches the SpMM; the CPU's runs the plain
    versions and agrees with it to 1e-4 + 1e-4 |live|."""
    from gala_tpu_torch.export import export_compiled, load_exported

    cm = _compiled_gcn(cuda)
    d = export_compiled(cm, str(tmp_path / "artifact"), platforms=("cuda", "cpu"))
    live = cm.forward(cm.make_params(0), cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
    _build.reset_counts()
    on_card = load_exported(d).forward()
    torch.cuda.synchronize()
    assert torch.equal(on_card, live) and kernel.counts.launches > 0
    on_cpu = load_exported(d, device="cpu").forward()
    assert on_cpu.device.type == "cpu" and kernel.counts.reference_calls_on_cuda == 0
    assert (on_cpu - live.cpu()).abs().le(1e-4 + 1e-4 * live.cpu().abs()).all()
