"""The attention kernels' row pitch (ops.kernels.attn_bell row_pitch,
pad_heads, unpad_heads, bwd2_table), on the CPU.

A head whose width fh is not a multiple of 4 runs in the CUDA wrappers
at fh rounded up to a lane (4 columns; 8 in the bf16 forward, whose
lanes load 16 bytes), its columns at h * pitch and zeros after them.
Here: where the helpers put each head and that they give back every
value; that the plain versions run on the pitched tables give the
unpitched results (the zero columns add 0); that bwd2's table has one
format, pitched, on the CPU too; that a width of 4k columns is handed
on with no copy and a misaligned view as an aligned copy; and what each
launch receives: the pitched width only where a call pads, the lanes
that give the multi-head forms their slices, while the aggregation's
own `gala.attention` counts keep the unpadded width (the wrappers run on
CPU tensors with the launch mocked: the kernels have no CPU mode; the
card tests in tests/test_torch_kernels.py run them)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gala_tpu_torch.data.csr import coo_to_csr
from gala_tpu_torch.ops import attention as TA
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.kernels import attn_bell as KA
from gala_tpu_torch.utils import profiling
from tests.test_torch_kernels import record_launches

torch.set_num_threads(2)

SLOPE = 0.2
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module")
def graph():
    """300 nodes, an in-hub of 400 sources (node 3: a split row of the fwd
    layout) and an out-hub of 250 destinations (node 5: one of the
    transpose's), self-loops on every third node, the last 10 isolated."""
    rng = np.random.default_rng(7)
    n, m = 300, 290
    src = np.concatenate([rng.integers(0, m, 2000), rng.integers(0, m, 400), np.full(250, 5),
                          np.arange(0, m, 3)])
    dst = np.concatenate([rng.integers(0, m, 2000), np.full(400, 3), rng.integers(0, m, 250),
                          np.arange(0, m, 3)])
    key = np.unique(src.astype(np.int64) * n + dst)
    return Graph.from_host(coo_to_csr(key // n, key % n, None, n_rows=n), strategy="bell",
                           attention=True, device="cpu")


# (fh, H, dtype, a lane's columns, the pitch): 41 (the Reddit GAT's output
# layer) in 4-column lanes and the bf16 forward's 8, three heads of 7 and
# 4 of 33, 8 heads of 5; widths of 4k columns (32, 40, 8 heads of 64 and
# of 4, bf16 heads of 12 in the 8-column lanes) keep their width
PITCHES = [(41, 1, F32, 4, 44), (41, 1, BF16, 8, 48), (41, 1, BF16, 4, 44), (7, 3, F32, 4, 8),
           (7, 3, BF16, 8, 8), (33, 4, F32, 4, 36), (5, 8, BF16, 8, 8), (32, 1, F32, 4, 32),
           (40, 1, F32, 4, 40), (40, 1, BF16, 8, 40), (64, 8, F32, 4, 64),
           (64, 8, BF16, 8, 64), (4, 8, BF16, 8, 4), (12, 2, BF16, 8, 12)]


@pytest.mark.parametrize("fh,nh,dtype,lane,pitch", PITCHES)
def test_pad_heads_places_each_head_at_its_pitch_and_gives_it_back(fh, nh, dtype, lane, pitch):
    """row_pitch rounds fh up to a lane where fh is not a multiple of 4;
    pad_heads puts head h at columns [h * pitch, h * pitch + fh) with
    zeros after it and unpad_heads gives back every value bit for bit,
    with or without a tail of columns after the heads; where fh keeps its
    width both return the tensor itself (no copy)."""
    assert KA.row_pitch(fh, lane) == pitch
    rows = 37
    t = torch.randn((rows, nh * fh), generator=torch.Generator().manual_seed(fh * nh)).to(dtype)
    tail = torch.randn((rows, nh)).to(dtype)
    p = KA.pad_heads(t, nh, pitch)
    if pitch == fh:
        assert p is t and KA.unpad_heads(p, nh, fh, pitch) is t
        assert KA.head_blocks(t, nh, pitch) == [t]
        return
    assert p.shape == (rows, nh * pitch) and p.dtype == dtype and p.is_contiguous()
    for h in range(nh):
        assert torch.equal(p[:, h * pitch : h * pitch + fh], t[:, h * fh : (h + 1) * fh])
        assert (p[:, h * pitch + fh : (h + 1) * pitch] == 0).all()
    back = KA.unpad_heads(p, nh, fh, pitch)
    assert back.shape == t.shape and torch.equal(back, t)
    if nh == 1:  # one head: a view of the pitched rows
        assert back.data_ptr() == p.data_ptr()
    tailed = KA.unpad_heads(torch.cat([p, tail], dim=1), nh, fh, pitch)
    assert torch.equal(tailed, torch.cat([t, tail], dim=1))


def _mock_launch(monkeypatch) -> list:
    """Leave the kernels' launch out; returns what each attention forward
    and bwd2 launch receives (tests.test_torch_kernels.record_launches)."""
    monkeypatch.setattr(KA, "build", lambda: SimpleNamespace(lib=None))
    return record_launches(monkeypatch)


def _inputs(g, hf, nh, seed):
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    return rand(g.c_pad, hf), rand(g.c_pad, nh), rand(g.n_pad, nh), rand(g.n_pad, hf)


@pytest.mark.parametrize("units", [False, True], ids=["plain", "units"])
@pytest.mark.parametrize("fh,nh", [(41, 1), (7, 3)])
def test_pitched_tables_give_the_unpitched_results(graph, fh, nh, units):
    """The three kernels' plain versions (and their units emulations, the
    kernels' sum order) on the pitched x, dout and w_tab, cut back, equal
    the same versions on the unpitched tables: out, out+ and dx bit for
    bit (each real column sums the same products in the same order);
    m, s, s+ bit for bit (vl and vr take no pitch); the dots over a
    head (bwd1's sds and A, bwd2's dvl), whose zero columns add 0 in
    another reduction order, to 1e-6 of their magnitudes."""
    g, hf = graph, nh * fh
    pitch = KA.row_pitch(fh)
    x, vl, vr, dout = _inputs(g, hf, nh, fh + nh)
    xp, doutp = KA.pad_heads(x, nh, pitch), KA.pad_heads(dout, nh, pitch)
    fwd = KA.attn_fwd_units_reference if units else KA.attn_fwd_reference
    bwd1 = KA.attn_bwd1_units_reference if units else KA.attn_bwd1_reference
    bwd2 = KA.attn_bwd2_units_reference if units else KA.attn_bwd2_reference

    want = fwd(g.attn.fwd, x, vl, vr, SLOPE, g.n_pad, True)
    got = fwd(g.attn.fwd, xp, vl, vr, SLOPE, g.n_pad, True)
    for i, (a, b) in enumerate(zip(got, want)):
        a = KA.unpad_heads(a, nh, fh, pitch) if i in (0, 3) else a
        assert torch.equal(a, b), i
    out, m, s, _, _ = want

    def close(a, b, scale):
        assert ((a - b).abs() <= 1e-6 * (1.0 + scale)).all()

    want = bwd1(g.attn.fwd, x, vl, vr, dout, m, s, SLOPE)
    got = bwd1(g.attn.fwd, xp, vl, vr, doutp, m, s, SLOPE)
    scale = bwd1(g.attn.fwd, x.abs(), vl, vr, dout.abs(), m, s, SLOPE)[0]
    for a, b in zip(got, want):
        close(a, b, scale)

    sds = KA.per_head_dot(dout, out, nh)
    w_tab = torch.cat([dout, vr, m, s, sds], dim=1)
    w_tabp = torch.cat([*KA.head_blocks(dout, nh, pitch), vr, m, s, sds], dim=1)
    assert w_tabp.shape == (g.n_pad, nh * pitch + 4 * nh)
    want = bwd2(g.attn.t, x, vl, w_tab, SLOPE, g.c_pad)
    # the table at its pitch with x as it stands (the card's checks): the same
    assert torch.equal(bwd2(g.attn.t, x, vl, w_tabp, SLOPE, g.c_pad), want)
    got = KA.unpad_heads(bwd2(g.attn.t, xp, vl, w_tabp, SLOPE, g.c_pad), nh, fh, pitch)
    assert got.shape == want.shape
    assert torch.equal(got[:, :hf], want[:, :hf])
    a_tab = torch.cat([dout.abs(), vr, m, s, -sds.abs()], dim=1)
    close(got[:, hf:], want[:, hf:], bwd2(g.attn.t, x.abs(), vl, a_tab, SLOPE, g.c_pad)[:, hf:])


@pytest.mark.parametrize("hf,nh", [(41, 1), (21, 3), (32, 1), (40, 1), (512, 8)])
def test_pitch_is_counted_only_where_a_call_pads(graph, monkeypatch, hf, nh):
    """attention_aggregate forward and backward with the op's CPU forms
    routed to the CUDA wrappers and the launch mocked, under a profiler:
    the aggregation counts `gala.attention` and `gala.attention.grad` at
    the unpadded width (the algorithm's bytes); the forward and bwd2 each
    launch once at the pitched width H * row_pitch(fh), which differs
    from hf only where fh is not a multiple of 4; bwd2 gets w_tab as the
    backward builds it (bwd2_table, pitched on CPU tensors too)."""
    g = graph
    tables = []

    def bwd2(lay, x, vl, w_tab, slope, c_pad, shared=False):
        tables.append(w_tab.shape[1])
        return KA.attn_bwd2_cuda(lay, x, vl, w_tab, slope, c_pad, shared)

    launched = _mock_launch(monkeypatch)
    monkeypatch.setattr(KA, "attn_fwd_reference", KA.attn_fwd_cuda)
    monkeypatch.setattr(KA, "attn_bwd2_reference", bwd2)
    x, vl, vr, _ = (t.requires_grad_(True) for t in _inputs(g, hf, nh, 3))
    with torch.profiler.profile():
        profiling.clear_counts()
        out = TA.attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
        out.backward(torch.ones_like(out))
        rec = profiling.counts()
    assert out.shape == (g.n_pad, hf) and x.grad.shape == x.shape
    fh = hf // nh
    pitch = KA.row_pitch(fh)
    assert tables == [nh * pitch + 4 * nh]
    by_name = {}
    for r in rec:
        by_name.setdefault(r["name"], []).append(r)
    assert [r["width"] for r in by_name["gala.attention"]] == [hf]
    assert [r["width"] for r in by_name["gala.attention.grad"]] == [hf]
    assert [(name, lanes[:2]) for name, lanes in launched] == [
        ("attn_fwd", (nh * pitch, nh)), ("attn_bwd2", (nh * pitch, nh))]
    assert (nh * pitch != hf) == (fh % 4 != 0)


def test_bwd2_takes_a_pitched_table_only_where_it_runs_the_kernel(graph):
    """bwd2's table has one format on both devices: on CPU tensors (the
    plain version) bwd2_table writes dout's block at the kernel's row
    pitch (41 -> 44 columns, zeros after the head), attn_bwd2 takes that
    table and refuses the unpitched one, and its result is the one the
    unpitched table gives the plain version."""
    g = graph
    x, vl, vr, dout = _inputs(g, 41, 1, 0)
    m = s = sds = torch.ones((g.n_pad, 1))
    w_tab = KA.bwd2_table(x, dout, vr, m, s, sds)
    assert torch.equal(w_tab, torch.cat([KA.pad_heads(dout, 1, 44), vr, m, s, sds], dim=1))
    unpitched = torch.cat([dout, vr, m, s, sds], dim=1)
    with pytest.raises(ValueError):
        KA.attn_bwd2(g.attn.t, x, vl, unpitched, SLOPE, g.c_pad)
    got = KA.attn_bwd2(g.attn.t, x, vl, w_tab, SLOPE, g.c_pad)
    assert got.shape == (g.c_pad, 42)
    assert torch.equal(got, KA.attn_bwd2_reference(g.attn.t, x, vl, unpitched, SLOPE, g.c_pad))


@pytest.mark.parametrize("kind", ["fwd", "bwd1", "bwd2"])
def test_a_misaligned_view_reaches_the_kernel_as_an_aligned_copy(graph, monkeypatch, kind):
    """Every lane loads 16 (or 8) bytes, so each wrapper hands its kernel
    16-byte aligned feature tables: x a view 4 bytes into its storage (hf
    = 32, which needs no pitch) goes on as an aligned copy, and an aligned
    x as itself."""
    g = graph
    launched = []
    monkeypatch.setattr(KA, "build", lambda: SimpleNamespace(lib=None))
    monkeypatch.setattr(KA, "launch", lambda lib, name, t, *args: launched.append(args))
    _, vl, vr, dout = _inputs(g, 32, 1, 5)
    base = torch.randn(g.c_pad * 32 + 1)
    views = (base[1:].view(g.c_pad, 32), base[:-1].view(g.c_pad, 32))
    m, s = torch.zeros(g.n_pad, 1), torch.ones(g.n_pad, 1)
    for x in views:
        if kind == "fwd":
            KA.attn_fwd_cuda(g.attn.fwd, x, vl, vr, SLOPE, g.n_pad, True)
        elif kind == "bwd1":
            KA.attn_bwd1_cuda(g.attn.fwd, x, vl, vr, dout, m, s, SLOPE)
        else:
            KA.attn_bwd2_cuda(g.attn.t, x, vl, KA.bwd2_table(x, dout, vr, m, s, s), SLOPE,
                              g.c_pad)
    i_x = 1 if kind == "bwd2" else 0
    (misaligned, aligned) = (args[i_x] for args in launched)
    assert views[0].data_ptr() % 16 and misaligned % 16 == 0
    assert aligned == views[1].data_ptr()


# (hf, H, dtype, slices the forward's warp walks, bwd2's): one head takes
# the one-head forms (slices not asserted); 8 heads of 8 and of 41 (pitch
# 44, 352 columns: 88 float4 vectors in 3 slices of 32 lanes; 48 at bf16
# in the forward's 8-column lanes, 2 slices), 6 heads of 8 and 2 heads of 8
HEAD_CALLS = [(32, 1, F32, None, None), (41, 1, F32, None, None), (64, 8, F32, 1, 1),
              (328, 8, F32, 3, 3), (328, 8, BF16, 2, 3), (48, 6, F32, 1, 1), (16, 2, F32, 1, 1)]


@pytest.mark.parametrize("hf,nh,dtype,fwd_slices,bwd2_slices", HEAD_CALLS)
def test_heads_are_counted_once_per_call_at_more_than_one_head(graph, monkeypatch, hf, nh, dtype,
                                                               fwd_slices, bwd2_slices):
    """attention_aggregate forward and backward with the op's CPU forms
    routed to the CUDA wrappers and the launch mocked: the forward and
    bwd2 each launch once, at H heads (the kernels pick the multi-head
    form from it at H > 1), with lanes vec and log2_g whose slices of
    2^log2_g lanes over the row's hf / vec vectors are the 1, 2 or 3 the
    table names."""
    g = graph
    launched = _mock_launch(monkeypatch)
    monkeypatch.setattr(KA, "attn_fwd_reference", KA.attn_fwd_cuda)
    monkeypatch.setattr(KA, "attn_bwd2_reference", KA.attn_bwd2_cuda)
    x, vl, vr, _ = (t.to(dtype).requires_grad_(True) for t in _inputs(g, hf, nh, 4))
    out = TA.attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
    out.backward(torch.ones_like(out))
    assert [(name, lanes[1]) for name, lanes in launched] == [("attn_fwd", nh),
                                                              ("attn_bwd2", nh)]
    if nh > 1:
        assert [lanes[2] for _, lanes in launched] == [fwd_slices, bwd2_slices]


def test_the_plain_path_counts_no_heads(graph, monkeypatch):
    """On CPU tensors the plain versions run: nothing is launched, and the
    aggregation's own counts are recorded as before, `gala.attention`
    with the layout's real destination rows and nonzeros, x's width, the
    heads and x's item size, its gradient with the real source rows and
    the heads of its dout block (8: no mean over the heads)."""
    g = graph
    launched = _mock_launch(monkeypatch)
    x, vl, vr, _ = (t.requires_grad_(True) for t in _inputs(g, 64, 8, 6))
    with torch.profiler.profile():
        profiling.clear_counts()
        out = TA.attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
        out.backward(torch.ones_like(out))
        rec = profiling.counts()
    assert launched == []
    work = {"nnz": g.attn.n_edges, "width": 64, "heads": 8, "itemsize": 4}
    assert rec == [{"name": "gala.attention", "rows": g.attn.n_rows, **work},
                   {"name": "gala.attention.grad", "rows": g.attn.n_cols, **work,
                    "dout_heads": 8}]
