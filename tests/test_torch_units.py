"""The work that the SpMM and the attention forward give a warp: several
short units (gala_tpu_torch.ops.graph warp_tables, WorkUnits.warps), and
the unit-order plain versions those kernels are held to on the card,
against gala_tpu.

The graph has many rows of 1 to 8 slots (the short units that a warp
takes several of) and three in-hubs of 300, 700 and 1,300 edges (rows of
3, 6 and 11 units, one warp a unit).  JAX runs its XLA executors on the
CPU; the port runs bell_spmm_units_reference and attn_fwd_units_reference,
the kernels' two passes in plain PyTorch.  Tolerances: at f32 rtol = atol
= 1e-5 for the SpMM and 1e-4 for the attention forward (both sides sum in
f32, in other orders; the forward's exponentials add their rounding), as
tests/test_torch_spmm.py and tests/test_torch_attention.py hold them.  At
bf16 both sides read the same bf16 features (JAX as f32); the port's SpMM
rounds the slot values to bf16 before the product (gala_tpu's
vals.astype(x.dtype)) and each f32 sum once to bf16, each by at most
bf16's unit roundoff 2^-8, so it may also be 2^-7 of the summed
magnitudes from JAX's f32 result (tests/test_torch_bf16.py's OP_RTOL);
the attention forward computes in f32 from the same values and its
outputs are f32 at either type.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import gala_tpu.ops.attention as JA
from gala_tpu.data.csr import coo_to_csr as jcoo_to_csr
from gala_tpu.ops.graph import Graph as JGraph
from gala_tpu.ops.spmm import spmm as jspmm
from gala_tpu_torch.data.csr import coo_to_csr as tcoo_to_csr
from gala_tpu_torch.ops.graph import (
    PACKED_LANES, UNIT_LEVELS, UNIT_SLOTS, Graph as TGraph, row_lanes, unit_levels,
    warp_tables, work_unit_tables,
)
from gala_tpu_torch.ops.kernels import attn_bell as KA
from gala_tpu_torch.ops.kernels import bell_spmm as KB
from gala_tpu_torch.ops.kernels import library
from tests.test_torch_graph import check_units

torch.set_num_threads(2)

WIDTHS = [1, 3, 32, 40, 128]
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_SLACK = 2.0**-7
SLOPE = 0.2
HUBS = {0: 300, 1: 700, 2: 1300}
TILE = 700


def short_row_coo(seed=3, n=2000):
    """(src, dst, vals, n): every node but the hubs has 1 to 8 in-edges
    (most 1 to 4), the hubs HUBS extra ones; self-loops on every third node;
    weights in [0.5, 1.5); duplicate edges dropped."""
    rng = np.random.default_rng(seed)
    deg = rng.choice(np.arange(1, 9), size=n, p=[.2, .2, .15, .15, .1, .1, .05, .05])
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    for hub, extra in HUBS.items():
        dst = np.concatenate([dst, np.full(extra, hub)])
        src = np.concatenate([src, rng.choice(n, extra, replace=False)])
    loops = np.arange(0, n, 3)
    key = np.unique(np.concatenate([src, loops]).astype(np.int64) * n
                    + np.concatenate([dst, loops]))
    src, dst = key // n, key % n
    vals = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
    return src, dst, vals, n


@pytest.fixture(scope="module")
def pair():
    src, dst, vals, n = short_row_coo()
    jg = JGraph.from_host(jcoo_to_csr(src, dst, vals, n_rows=n), strategy="bell")
    tg = TGraph.from_host(tcoo_to_csr(src, dst, vals, n_rows=n), strategy="bell", device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def attn_pair():
    src, dst, _, n = short_row_coo()
    jg = JGraph.from_host(jcoo_to_csr(src, dst, None, n_rows=n), strategy="bell",
                          attention=True)
    tg = TGraph.from_host(tcoo_to_csr(src, dst, None, n_rows=n), strategy="bell",
                          attention=True, device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def tiled():
    src, dst, vals, n = short_row_coo()
    return TGraph.from_host(tcoo_to_csr(src, dst, vals, n_rows=n), strategy="bell",
                            device="cpu", col_tile=TILE)


# --------------------------------------------------------------------------- #
# the warp tables
# --------------------------------------------------------------------------- #
def check_warps(units, tiles=None):
    """Every log2_g's warp table against the rule: warps in unit order, one
    after another, each unit in exactly one warp; a warp holds 1 to 32 >>
    log2_g units, all of one level and one column tile (`tiles`, each
    unit's; one tile when None), together at most UNIT_SLOTS slots; a run
    of units of one level and tile is cut into warps of min(2^l, 32 >>
    log2_g) units, the last of the run possibly fewer.  Returns the warp
    counts."""
    length = units.length.numpy().astype(np.int64)
    level = unit_levels(length)
    tiles = np.zeros_like(length) if tiles is None else tiles
    counts = []
    for log2_g in range(PACKED_LANES + 1):
        table, n_warps = units.warps(log2_g)
        if log2_g == PACKED_LANES:
            assert table is None and n_warps == units.n_units  # one unit a warp
            counts.append(n_warps)
            continue
        lo, hi = units.warp_off[log2_g], units.warp_off[log2_g + 1]
        first = units.warp_first[lo:hi].numpy().astype(np.int64)
        assert table == units.warp_first[lo:].data_ptr() and n_warps == first.shape[0] - 1
        assert first[0] == 0 and first[-1] == units.n_units
        count = np.diff(first)
        assert (count >= 1).all() and (count <= 32 >> log2_g).all()
        for a, b in zip(first[:-1], first[1:]):
            assert len(set(level[a:b])) == 1 and len(set(tiles[a:b])) == 1, (log2_g, a, b)
            assert length[a:b].sum() <= UNIT_SLOTS
            assert length[a:b].max() <= UNIT_SLOTS >> level[a]
        # only a run's last warp is short
        per = np.minimum(1 << level[first[:-1]], 32 >> log2_g)
        run_end = np.append((level[first[1:-1]] != level[first[:-2]])
                            | (tiles[first[1:-1]] != tiles[first[:-2]]), True)
        assert ((count == per) | run_end).all()
        counts.append(n_warps)
    return counts


@pytest.mark.parametrize("side", ["bell", "t_bell", "attn fwd", "attn t"])
def test_warp_tables_cover_every_unit_once(pair, attn_pair, side):
    """Each layout's units still cover every described slot once (the unit
    cut is unchanged), and each log2_g's warps cover every unit once under
    the packing rule; fewer lanes across a row give a warp more units."""
    lay = {"bell": pair[1].bell, "t_bell": pair[1].t_bell, "attn fwd": attn_pair[1].attn.fwd,
           "attn t": attn_pair[1].attn.t}[side]
    check_units(lay)
    counts = check_warps(lay.units)
    assert counts == sorted(counts) and counts[0] < counts[-1] == lay.units.n_units


def test_the_short_units_are_packed(pair):
    """The graph's units: most are at the last level (at most 4 slots) and
    go 32 a warp at g = 1; at g = 8 (F = 32 in f32) units of at most 32
    slots go 4 a warp; the hubs' units of 128 slots one a warp at every g."""
    u = pair[1].bell.units
    length = u.length.numpy()
    level = unit_levels(length)
    assert (level == UNIT_LEVELS - 1).mean() > 0.5 and (length <= 8).mean() > 0.9
    for log2_g, per in ((0, 32), (3, 4)):
        lo, hi = u.warp_off[log2_g], u.warp_off[log2_g + 1]
        first = u.warp_first[lo:hi].numpy()
        count = np.diff(first)
        assert count.max() == per and (count[level[first[:-1]] == UNIT_LEVELS - 1] > 1).any()
        full = length[first[:-1]] == UNIT_SLOTS
        assert full.sum() == (length == UNIT_SLOTS).sum() and (count[full] == 1).all()


def test_split_rows_keep_their_partials(pair):
    """The warp tables leave the unit tables alone: a hub's units write its
    partials in slot order and the merge tables name them, as
    check_units holds, and every hub unit of 128 slots is alone in its warp
    at every g."""
    u = pair[1].bell.units
    split = u.part.numpy() >= 0
    hub_nodes = set(u.split_node.tolist())
    assert hub_nodes == set(HUBS) and u.n_partials == int(split.sum())
    length = u.length.numpy()
    for log2_g in range(PACKED_LANES):
        lo, hi = u.warp_off[log2_g], u.warp_off[log2_g + 1]
        first = u.warp_first[lo:hi].numpy()
        for a, b in zip(first[:-1], first[1:]):
            if length[a] == UNIT_SLOTS:
                assert b - a == 1


def test_warp_tables_of_column_tiled_layouts(tiled):
    """With col_tile a warp's units lie in one column tile (units run
    tile-major, longest first within a tile, one packing run per tile and
    level)."""
    for lay in (tiled.bell, tiled.t_bell):
        cols = lay.flat_cols.numpy()
        u = lay.units
        tiles = cols[u.start.numpy()] // TILE
        tiles[u.length.numpy() == 0] = 0  # an empty row's unit sits in tile 0
        assert (np.diff(tiles) >= 0).all()
        check_warps(u, tiles)


def test_warp_tables_past_2_31_slots():
    """Starts past 2^31 (int64) change no warp table: the tables depend on
    the units' lengths and tiles alone."""
    lens = np.array([3, 300, 0, 5, 2, 128, 7, 1, 4], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    near = work_unit_tables(starts, lens, np.arange(lens.shape[0]))
    far = work_unit_tables(starts + 2**33 + 5, lens, np.arange(lens.shape[0]))
    assert far["start"].dtype == np.int64
    np.testing.assert_array_equal(far["start"], near["start"] + 2**33 + 5)
    for key in ("warp_first", "warp_off", "length", "part"):
        np.testing.assert_array_equal(far[key], near[key])
    assert far["warp_first"].dtype == np.int32 and far["warp_off"].dtype == np.int32


@pytest.mark.parametrize("lengths,log2_g,want", [
    ([128, 5, 3, 2, 1], 0, [0, 1, 2, 5]),        # levels 0, 4, 5, 5, 5
    ([128, 5, 3, 2, 1], 4, [0, 1, 2, 4, 5]),     # two units a warp at g = 16
    ([64, 64, 40, 33], 0, [0, 2, 4]),             # level 1: two a warp
    ([32] * 5 + [16] * 3, 3, [0, 4, 5, 8]),       # g = 8: four a warp
    ([4] * 40, 0, [0, 32, 40]),
    ([0, 0, 0], 2, [0, 3]),                       # empty rows: the last level
    ([], 0, [0]),
])
def test_warp_tables_by_hand(lengths, log2_g, want):
    length = np.array(lengths, np.int64)
    tables, off = warp_tables(length, np.zeros_like(length))
    assert off.shape == (PACKED_LANES + 1,)
    np.testing.assert_array_equal(tables[off[log2_g] : off[log2_g + 1]], want)


def test_warp_tables_cut_at_tile_boundaries():
    """Units of one level in two tiles go to separate warps."""
    length = np.array([4, 4, 4, 4, 4], np.int64)
    tables, off = warp_tables(length, np.array([0, 0, 0, 1, 1]))
    np.testing.assert_array_equal(tables[off[0] : off[1]], [0, 3, 5])


@pytest.mark.parametrize("vectors", range(1, 70))
def test_row_lanes(vectors):
    """The smallest power of two that covers a row's vectors, at most 32:
    csrc/unit_gather.cuh's row_lanes, which the C entry points check."""
    got = row_lanes(vectors)
    assert 0 <= got <= PACKED_LANES and (1 << got >= vectors or got == PACKED_LANES)
    assert got == 0 or (1 << (got - 1)) < vectors


@pytest.mark.parametrize("dtype,width,want", [
    (torch.float32, 128, 4), (torch.float32, 40, 4), (torch.float32, 33, 1),
    (torch.float32, 1, 1), (torch.bfloat16, 128, 8), (torch.bfloat16, 40, 8),
    (torch.bfloat16, 36, 4), (torch.bfloat16, 3, 1),
])
def test_vector_width(dtype, width, want):
    """16 bytes a lane where the row holds them (4 f32, 8 bf16), at bf16 8
    bytes where only 4 columns divide it; and x misaligned by one element
    takes scalars."""
    x = torch.zeros((6, width + 1), dtype=dtype)
    assert KB.vector_width(x[:, :width].contiguous()) == want
    assert KB.vector_width(x.view(-1)[1 : 1 + 5 * width].view(5, width)) == 1
    assert KB.vector_width(x, 8) == 16 // x.element_size()


def test_custom_op_layouts_keep_the_warp_tables(pair, attn_pair):
    """layout_args / layout_of (the custom ops' boundary, the export
    artifact, each rank's layouts) carry the warp tables and offsets."""
    for lay in (pair[1].bell, pair[1].t_bell, attn_pair[1].attn.fwd):
        back = library.layout_of(*library.layout_args(lay))
        assert back.units.warp_off == lay.units.warp_off
        assert torch.equal(back.units.warp_first, lay.units.warp_first)
        for log2_g in range(PACKED_LANES + 1):
            assert back.units.warps(log2_g)[1] == lay.units.warps(log2_g)[1]
        assert back.units.n_written == lay.units.n_written


@pytest.mark.parametrize("nodes,want", [
    ([0, 1, 2, 3, 4], 5), ([4, 0, 2, 1, 3], 5), ([0, 1, 2, 4, 5], 3), ([1, 2, 3, 4, 5], 0),
    ([0, 0, 1, 3, 3], 2),
])
def test_n_written_is_the_first_row_no_row_describes(nodes, want):
    """The kernels zero only the output rows from n_written on: every row
    below it is some descriptor row's node (a row of no slots too)."""
    lens = np.array([3, 300, 0, 5, 2], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    assert int(work_unit_tables(starts, lens, nodes)["n_written"]) == want
    assert int(work_unit_tables([], [], [])["n_written"]) == 0


def test_graph_layouts_write_every_real_row(pair, attn_pair, tiled):
    """On the graph's layouts every real row is some unit's node, so the
    kernels zero the padding rows alone."""
    for lay in (pair[1].bell, pair[1].t_bell, attn_pair[1].attn.fwd, attn_pair[1].attn.t,
                tiled.bell):
        assert lay.units.n_written == lay.n_real
        written = set(lay.units.node[lay.units.part < 0].tolist())
        written |= set(lay.units.split_node.tolist())
        assert written >= set(range(lay.units.n_written))


# --------------------------------------------------------------------------- #
# what the attention bindings hand their kernels
# --------------------------------------------------------------------------- #
# kind: (the layout's side, index of the warp table among the C arguments,
# index of n_warps, of the output rows n_out, of zero_from, of vec, of log2_g)
_ARGS = {"fwd": ("fwd", 9, 19, 22, 23, 27, 28), "bwd1": ("fwd", 12, 18, 20, 21, 25, 26),
         "bwd2": ("t", 9, 15, 17, 18, 22, 23)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh", [1, 4])
@pytest.mark.parametrize("hf", [32, 40, 132])
@pytest.mark.parametrize("kind", sorted(_ARGS))
def test_attention_bindings_pass_the_warp_tables(attn_pair, monkeypatch, kind, hf, nh, dtype):
    """Each attention binding (its CUDA half run on CPU tensors, the launch
    mocked) hands its C entry the layout's warp table for log2_g =
    row_lanes(hf / vec) (none at 32 lanes, where a warp takes one unit),
    that table's warp count, log2_g itself, and n_written clipped to the
    output rows as the first row to zero: the forward and bwd1 from the
    fwd layout's WorkUnits, bwd2 from the transpose layout's.  Every head
    runs at its row pitch (fh 33 and 10 padded to 36 and 12, in the bf16
    forward to 40 and 16), so vec is 16 bytes of x a lane in the forward
    where the pitch holds them (8 bytes at bf16 fh = 132), 4 columns in
    bwd1 and bwd2, and hf the pitched width; where fh is a multiple of 4,
    the call hands the kernel x itself, and every call returns hf-wide
    outputs."""
    _, tg = attn_pair
    side, i_table, i_warps, i_rows, i_zero, i_vec, i_log2 = _ARGS[kind]
    i_x, i_hf = (1 if kind == "bwd2" else 0), i_vec - 3
    lay = getattr(tg.attn, side)
    gen = torch.Generator().manual_seed(hf + nh)
    rand = lambda *shape: torch.randn(shape, generator=gen).to(dtype)  # noqa: E731
    x, vl, vr, dout = rand(tg.c_pad, hf), rand(tg.c_pad, nh), rand(tg.n_pad, nh), rand(tg.n_pad, hf)
    m, s = torch.zeros(tg.n_pad, nh), torch.ones(tg.n_pad, nh)
    lane = 16 // dtype.itemsize if kind == "fwd" else 4
    pitch = KA.row_pitch(hf // nh, lane)
    launched = []
    monkeypatch.setattr(KA, "build", lambda: SimpleNamespace(lib=None))
    monkeypatch.setattr(KA, "launch", lambda lib, name, t, *args: launched.append((name, args)))
    if kind == "fwd":
        got = KA.attn_fwd_cuda(lay, x, vl, vr, SLOPE, tg.n_pad, True)
        n_out, vec, wide_outs = tg.n_pad, lane if pitch % lane == 0 else 4, (got[0], got[3])
    elif kind == "bwd1":
        got = KA.attn_bwd1_cuda(lay, x, vl, vr, dout, m, s, SLOPE)
        n_out, vec, wide_outs = tg.n_pad, 4, ()
        assert all(t.shape == (tg.n_pad, nh) for t in got)
    else:
        w_tab = torch.zeros(tg.n_pad, nh * pitch + 4 * nh)
        got = KA.attn_bwd2_cuda(lay, x, vl, w_tab, SLOPE, tg.c_pad)
        n_out, vec, wide_outs = tg.c_pad, 4, ()
        assert got.shape == (tg.c_pad, hf + nh)
    assert all(t.shape == (n_out, hf) for t in wide_outs)
    (name, args), = launched
    assert name == f"attn_{kind}" and len(args) + 1 == len(KA.FUNCTIONS[f"gala_{name}_f32"])
    assert args[i_hf] == nh * pitch
    assert (args[i_x] == x.data_ptr()) == (pitch == hf // nh)
    u = lay.units
    log2_g = row_lanes(nh * pitch // vec)
    table, n_warps = u.warps(log2_g)
    assert (args[i_vec], args[i_log2]) == (vec, log2_g)
    assert (args[i_table], args[i_warps]) == (table, n_warps)
    if log2_g < PACKED_LANES:
        assert table == u.warp_first[u.warp_off[log2_g]:].data_ptr() and n_warps < u.n_units
    else:
        assert table is None and n_warps == u.n_units
    assert (args[i_rows], args[i_zero]) == (n_out, min(u.n_written, n_out))
    assert u.n_written == lay.n_real


# --------------------------------------------------------------------------- #
# the unit-order plain versions against gala_tpu
# --------------------------------------------------------------------------- #
_OFFS = np.cumsum([0] + WIDTHS)


def _bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def spmm_oracle(pair):
    """JAX's bell SpMM of one wide input (every width a column slice), on
    values that bf16 holds exactly, so one JAX run serves f32 and bf16."""
    jg, tg = pair
    x = np.random.default_rng(1).standard_normal((tg.c_pad, _OFFS[-1])).astype(np.float32)
    x[tg.n_cols:] = 0.0
    x = _bf16_values(x)
    return x, np.asarray(jax.jit(jspmm)(jg, x)), np.asarray(jax.jit(jspmm)(jg, np.abs(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", WIDTHS)
def test_spmm_units_reference_matches_jax(pair, spmm_oracle, f, dtype):
    _, tg = pair
    i = WIDTHS.index(f)
    x, want, scale = (np.ascontiguousarray(a[:, _OFFS[i] : _OFFS[i + 1]]) for a in spmm_oracle)
    got = KB.bell_spmm_units_reference(tg.bell, torch.from_numpy(x).to(dtype), tg.n_pad)
    assert got.dtype == dtype and got.shape == (tg.n_pad, f)
    got = got.float().numpy()
    slack = BF16_SLACK * scale if dtype == torch.bfloat16 else 0.0
    err = np.abs(got - want)
    assert (err <= SPMM_TOL["atol"] + SPMM_TOL["rtol"] * scale + slack).all(), err.max()
    if dtype == torch.float32:  # and the bin-by-bin plain version, to the same tolerance
        plain = KB.bell_spmm_reference(tg.bell, torch.from_numpy(x), tg.n_pad).numpy()
        assert (np.abs(got - plain) <= SPMM_TOL["atol"] + SPMM_TOL["rtol"] * scale).all()


@pytest.fixture(scope="module", params=[(32, 1), (40, 1), (32, 4), (40, 4)],
                ids=lambda p: f"hf{p[0]}-H{p[1]}")
def attn_oracle(request, attn_pair):
    """JAX's chunked attention forward (out, m, s, out+, s+) at (hf, H), on
    values that bf16 holds exactly."""
    jg, tg = attn_pair
    hf, nh = request.param
    rng = np.random.default_rng(hf + nh)
    f = lambda *shape: _bf16_values(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    x, vl, vr = f(tg.c_pad, hf), f(tg.c_pad, nh), f(tg.n_pad, nh)
    fwd = jax.jit(lambda *a: JA._attn_fwd_chunked(jg.attn, *a, SLOPE, jg.n_pad))
    out, _, _, _, m, s, flash = fwd(x, vl, vr)
    want = [np.asarray(v) for v in (out, m, s, flash[1], flash[2])]
    return (x, vl, vr), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_fwd_units_reference_matches_jax(attn_pair, attn_oracle, dtype):
    _, tg = attn_pair
    inputs, want = attn_oracle
    x, vl, vr = (torch.from_numpy(a).to(dtype) for a in inputs)
    assert tg.attn.fwd.units.n_partials > 0, "the in-hubs must split into units"
    got = KA.attn_fwd_units_reference(tg.attn.fwd, x, vl, vr, SLOPE, tg.n_pad, flash=True)
    for name, g, w in zip(("out", "m", "s", "out+", "s+"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **ATTN_TOL)


# --------------------------------------------------------------------------- #
# the SDDMM's split of an edge list over warps, groups and lanes
# --------------------------------------------------------------------------- #
def sddmm_split(n_edges: int, fv: int, per_lane: int):
    """The host mirror of csrc/sddmm.cu sddmm_kernel's split: a warp takes a
    run of 32 * per_lane edges, lane l holding the indices of edges
    per_lane * l .. per_lane * l + per_lane - 1 of it; gs = min(fv, 32)
    lanes a group, ng = 32 // gs groups; group k takes the batches of
    holder lanes k, k + ng, k + 2 ng, ... < 32, one a step, and in each
    of its edges lane `sub` of the group reads vectors sub, sub + gs, ...
    < fv.  Returns (edge, warp, group, step) of every edge the groups
    take, and each group's (first lane, lanes, vectors of each lane)."""
    run = 32 * per_lane
    gs = min(fv, 32)
    ng = 32 // gs
    warps = -(-n_edges // run)
    steps = -(-32 // ng)
    w, k, s, u = np.meshgrid(np.arange(warps), np.arange(ng), np.arange(steps),
                             np.arange(per_lane), indexing="ij")
    holder = k + s * ng
    edge = w.astype(np.int64) * run + holder * per_lane + u
    live = (holder < 32) & (edge < n_edges)
    lanes = [(k * gs, gs, [list(range(sub, fv, gs)) for sub in range(gs)]) for k in range(ng)]
    return edge[live], w[live], k[live], s[live], lanes


def _sddmm_edges_per_lane():
    import re

    from gala_tpu_torch.ops.kernels import sddmm

    with open(sddmm._SRC) as f:
        return int(re.search(r"constexpr int kEdgesPerLane = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("fv", [1, 4, 5, 8, 10, 32, 33, 40])
@pytest.mark.parametrize("n_edges", [1, 127, 128, 129, 2**20 + 3])
def test_sddmm_split_takes_every_edge_once(n_edges, fv):
    """Every edge of the list is taken by exactly one group of one warp, in
    its warp's run; a group takes its batches in order, 4 ng edges apart,
    the warp's groups on neighbouring batches at each step; the groups'
    lanes are disjoint and inside the warp, and in every edge each of the
    row's fv vectors is read by exactly one lane of its group (F / VEC =
    fv: 5 and 10 are F = 40 at bf16 and f32, not rounded to a power of
    two)."""
    per_lane = _sddmm_edges_per_lane()
    edge, warp, group, step, lanes = sddmm_split(n_edges, fv, per_lane)
    ng = 32 // min(fv, 32)
    assert np.array_equal(np.bincount(edge, minlength=n_edges), np.ones(n_edges, np.int64))
    assert (edge // (32 * per_lane) == warp).all()
    batch = edge % (32 * per_lane) // per_lane  # the holder lane of each edge
    assert (batch == group + step * ng).all()
    order = np.lexsort((edge, step, group, warp))
    e, w, k = edge[order], warp[order], group[order]
    same = (w[1:] == w[:-1]) & (k[1:] == k[:-1])
    gaps = np.diff(e)[same]
    assert ((gaps == 1) | (gaps == per_lane * (ng - 1) + 1)).all()  # in order, batch after batch
    used = np.zeros(32, np.int64)
    for first, gs, vectors in lanes:
        used[first : first + gs] += 1
        assert sorted(j for v in vectors for j in v) == list(range(fv))
    assert used.max() == 1 and used.sum() == ng * min(fv, 32)


@pytest.mark.parametrize("dtype,width,want", [
    (torch.float32, 32, 4), (torch.float32, 40, 4), (torch.float32, 33, 1),
    (torch.bfloat16, 32, 8), (torch.bfloat16, 40, 8), (torch.bfloat16, 36, 4),
    (torch.bfloat16, 1, 1),
])
def test_sddmm_lane_width(dtype, width, want):
    """The SDDMM wrapper's lane width: vector_width taken over both
    operands (16 bytes where F and both tables allow it, 8 bytes of 4 bf16
    columns where only 4 divide F), and 1 where either operand lies one
    element off its alignment."""
    from gala_tpu_torch.ops.kernels import sddmm

    a, b = torch.zeros((7, width), dtype=dtype), torch.zeros((5, width), dtype=dtype)
    assert sddmm.lane_width(a, b) == want == min(KB.vector_width(a), KB.vector_width(b))
    off = torch.zeros(7 * width + 1, dtype=dtype)[1:].view(7, width)
    assert sddmm.lane_width(off, b) == sddmm.lane_width(b, off[:5]) == (want if width == 1 else 1)


# --------------------------------------------------------------------------- #
# what the sampled SpMM's binding hands its kernel
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def sampled_graph():
    src, dst, vals, n = short_row_coo()
    return TGraph.from_host(tcoo_to_csr(src, dst, vals, n_rows=n), strategy="bell",
                            device="cpu", dynamic_sample=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("side", ["bell", "t_bell"])
def test_sampled_spmm_binding_passes_the_sampling_inputs(sampled_graph, monkeypatch, side,
                                                         structural, dtype):
    """bell_spmm_sampled's CUDA half (run on CPU tensors, the launch
    mocked) calls gala_bell_spmm_dyn_<dtype> with the layout's DynSlots
    (deg, pos) after the values, the structural values or null, the
    unsampled call's unit tables, lanes and rows, and (k, ra, rb) before
    the stream; one launch counted under bell_spmm_dyn."""
    from gala_tpu_torch.ops.kernels import _build

    g = sampled_graph
    lay, meta, rows, n_out = ((g.bell, g.dyn_f, g.c_pad, g.n_pad) if side == "bell"
                              else (g.t_bell, g.dyn_t, g.n_pad, g.c_pad))
    x = torch.randn((rows, 32), generator=torch.Generator().manual_seed(2)).to(dtype)
    calls = {}

    def recorder(name):
        return lambda *args: calls.setdefault(name, args) and 0

    name = f"gala_bell_spmm_dyn_{_build.DTYPES[dtype]}"
    plain = f"gala_bell_spmm_{_build.DTYPES[dtype]}"
    lib = SimpleNamespace(**{n: recorder(n) for n in (name, plain)})
    monkeypatch.setattr(KB, "build", lambda: SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 0, raising=False)
    counts = _build.dtype_counts("bell_spmm_dyn", dtype)
    launches = counts.launches
    KB.bell_spmm_cuda(lay, x, n_out, sampled=(meta, 20, 96, 7, structural))
    KB.bell_spmm_cuda(lay, x, n_out)
    assert counts.launches == launches + 1
    got, want = calls[name], calls[plain]
    assert len(got) == len(KB.FUNCTIONS[name]) and len(want) == len(KB.FUNCTIONS[plain])
    assert got[2] == (lay.flat_vals.data_ptr() if structural else None)
    assert got[3:5] == (meta.deg.data_ptr(), meta.pos.data_ptr())
    # the unit tables and diag, then (out, part: fresh allocations), then the ints
    assert got[:2] == want[:2] and got[5:14] == want[3:12] and got[16:23] == want[14:21]
    assert (got[15] is None) == (want[13] is None) == (lay.units.n_partials == 0)
    assert got[-4:] == (20, 96, 7, 0)
