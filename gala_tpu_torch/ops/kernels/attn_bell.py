"""Fused slot-space attention: the three hand-written Hopper kernels, their
wrappers and their plain PyTorch versions.

Replaces gala_tpu/ops/pallas/attn_bell.py (attn_fwd_planned,
attn_bwd1_planned, attn_bwd2_planned); the maths is that of
gala_tpu/ops/attention.py (_head_softmax_pos and the hub branch of
_attn_fwd_chunked, _head_bwd_stats, _slot_grads).  The kernels
(`gala_tpu_torch/csrc/attn_bell.cu`) each cover a whole layout in one
launch from the per-row descriptors (ops.graph.BellDev.row_*); a hub is
one contiguous row.  Heads: x is (rows, hf) with head h in columns
[h*fh, (h+1)*fh), fh = hf / H, 1 <= H <= 8.

Layouts are ops.attention.AttnBell's: `flat_vals` holds slot occupancy
(1.0 per real edge, 0.0 on padding slots), used only as a mask.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor runs the
kernel or raises (no fallback).  `counts_for(name)` records launches and
plain-version calls on CUDA tensors for `attn_fwd`, `attn_bwd1` and
`attn_bwd2`.

The plain versions work slot by slot (one entry per slot of the flat
layout, a row's max by scatter_reduce and its sums by index_add_), so
they share nothing with the kernels but the layout.
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.kernels._build import CSRC_DIR, Build, build_library, counts_for

_SRC = os.path.join(CSRC_DIR, "attn_bell.cu")
_MAX_SLOTS = 2**31 - 1  # int32 slot offsets
MAX_HEADS = 8
NEG = -1e30  # masked score; a row's max is floored at NEG / 2 (gala_tpu's _NEG)

NAMES = ("attn_fwd", "attn_bwd1", "attn_bwd2")
counts = {name: counts_for(name) for name in NAMES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "attn_bell", {
        "gala_attn_fwd_f32": [_P] * 13 + [_I, _I, _I, _F, _I, _P],
        "gala_attn_bwd1_f32": [_P] * 14 + [_I, _I, _I, _F, _I, _P],
        "gala_attn_bwd2_f32": [_P] * 9 + [_I, _I, _I, _F, _I, _P],
    })


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _lrelu(z, slope):
    return torch.where(z > 0, z, slope * z)


def _slot_rows(lay) -> torch.Tensor:
    """(S,) int64: the descriptor row of every slot."""
    n_rows = lay.row_len.shape[0]
    rows = torch.arange(n_rows, device=lay.row_len.device)
    return torch.repeat_interleave(rows, lay.row_len.long(), output_size=lay.flat_cols.shape[0])


def _row_sum(rows, v, n_rows):
    return v.new_zeros((n_rows,) + v.shape[1:]).index_add_(0, rows, v)


def _to_nodes(lay, v, n_pad):
    """Descriptor-row values -> (n_pad, ...) in node order, 0 elsewhere."""
    out = v.new_zeros((n_pad,) + v.shape[1:])
    out[lay.row_node.long()] = v
    return out


def _note_cuda(name, t):
    if t.is_cuda:
        counts[name].reference_calls_on_cuda += 1


def attn_fwd_reference(lay, x, vl, vr, slope: float, n_pad: int, flash: bool):
    """Plain forward on a fwd layout.  Returns (out (n_pad, hf), m, s
    (n_pad, H), outpos (n_pad, hf), spos (n_pad, H)); outpos and spos are
    None unless `flash`.  out is f32 and serves as the flash residual out32.

    Masked slots score NEG; m = max(rowmax, NEG/2); s = 1 where the sum is
    0; a hub's max and sum run over all its virtual rows (one descriptor
    row); padding rows are 0."""
    _note_cuda("attn_fwd", x)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_rows = lay.row_node.shape[0]
    rows = _slot_rows(lay)
    col = lay.flat_cols.long()
    real = (lay.flat_vals != 0)[:, None]
    zpre = vl[col] + vr[lay.row_node.long()[rows]]                # (S, H)
    z = torch.where(real, _lrelu(zpre, slope), NEG)
    m = torch.full((n_rows, nh), NEG, dtype=z.dtype, device=z.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, nh), z, "amax").clamp_min(NEG / 2)
    p = torch.where(real, torch.exp(z - m[rows]), 0.0)
    s = _row_sum(rows, p, n_rows)
    s = torch.where(s > 0, s, 1.0)
    p = p / s[rows]
    xs = x[col].view(-1, nh, fh)
    out = _row_sum(rows, (p[..., None] * xs).view(-1, hf), n_rows)
    outpos = spos = None
    if flash:
        ppos = torch.where(zpre > 0, p, 0.0)
        outpos = _to_nodes(lay, _row_sum(rows, (ppos[..., None] * xs).view(-1, hf), n_rows), n_pad)
        spos = _to_nodes(lay, _row_sum(rows, ppos, n_rows), n_pad)
    return (_to_nodes(lay, out, n_pad), _to_nodes(lay, m, n_pad), _to_nodes(lay, s, n_pad),
            outpos, spos)


def attn_bwd1_reference(lay, x, vl, vr, dout, m, s, slope: float):
    """Plain backward pass 1 on a fwd layout: p recomputed from the
    node-order (m, s); dp = <dout[r], x[c]> per head; returns
    sds = sum p dp, A = sum p dp lrelu', B = sum p lrelu', each (n_pad, H)."""
    _note_cuda("attn_bwd1", x)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_rows = lay.row_node.shape[0]
    rows = _slot_rows(lay)
    col = lay.flat_cols.long()
    node = lay.row_node.long()[rows]
    real = (lay.flat_vals != 0)[:, None]
    zpre = vl[col] + vr[node]
    p = torch.where(real, torch.exp(_lrelu(zpre, slope) - m[node]) / s[node], 0.0)
    dp = (x[col].view(-1, nh, fh) * dout[node].view(-1, nh, fh)).sum(-1)
    lr = torch.where(zpre > 0, 1.0, slope)
    n_pad = dout.shape[0]
    return tuple(_to_nodes(lay, _row_sum(rows, v, n_rows), n_pad)
                 for v in (p * dp, p * dp * lr, p * lr))


def attn_bwd2_reference(lay, x, vl, w_tab, slope: float, c_pad: int):
    """Plain backward pass 2 on a transpose layout (rows = source nodes c,
    slots = destinations r): w_tab (n_pad, hf + 4H) = [dout | vr | m | s |
    sds] in node order.  Returns [dx | dvl] (c_pad, hf + H)."""
    _note_cuda("attn_bwd2", x)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_rows = lay.row_node.shape[0]
    rows = _slot_rows(lay)
    c = lay.row_node.long()[rows]
    w = w_tab[lay.flat_cols.long()]
    real = (lay.flat_vals != 0)[:, None]
    do = w[:, :hf].view(-1, nh, fh)
    vr_g, m_g, s_g, sds_g = (w[:, hf + i * nh : hf + (i + 1) * nh] for i in range(4))
    zpre = vl[c] + vr_g
    p = torch.where(real, torch.exp(_lrelu(zpre, slope) - m_g) / s_g, 0.0)
    dp = (do * x[c].view(-1, nh, fh)).sum(-1)
    dz = p * (dp - sds_g) * torch.where(zpre > 0, 1.0, slope)
    dx = _row_sum(rows, (p[..., None] * do).view(-1, hf), n_rows)
    dvl = _row_sum(rows, dz, n_rows)
    return _to_nodes(lay, torch.cat([dx, dvl], dim=1), c_pad)


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #
def _check(lay, x, vl, tables: dict, n_out: int) -> None:
    """dtype, shape and device checks shared by the wrappers; `tables`
    names the other tensor arguments."""
    nh = vl.shape[1] if vl.dim() == 2 else 0
    for name, t in {"x": x, "vl": vl, **tables}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"attention kernels take float32 tensors, {name} is {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.device != lay.flat_cols.device:
            raise ValueError(f"layout on {lay.flat_cols.device}, {name} on {t.device}")
    if not 1 <= nh <= MAX_HEADS or x.shape[1] % nh:
        raise ValueError(f"{nh} heads of {x.shape[1]} features: need 1 <= H <= "
                         f"{MAX_HEADS} dividing the width")
    if vl.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and vl {tuple(vl.shape)} must share rows")
    if n_out < lay.n_real:
        raise ValueError(f"{n_out} output rows < {lay.n_real} real rows")
    if lay.flat_cols.shape[0] > _MAX_SLOTS:
        raise NotImplementedError(
            "more than 2^31 slots needs int64 slot offsets: ROADMAP Queue 1 item 9")


def _vec(x, nh, *tables) -> int:
    """4 (float4 loads) when every head's width is a multiple of 4 and the
    feature tables are 16-byte aligned, else 1."""
    ok = (x.shape[1] // nh) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *tables))
    return 4 if ok else 1


def _launch(name, fn, x, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    counts[name].launches += 1


def _cuda_only(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")


def _lay_ptrs(lay):
    return (lay.flat_cols.data_ptr(), lay.flat_vals.data_ptr(), lay.row_start.data_ptr(),
            lay.row_len.data_ptr(), lay.row_node.data_ptr())


def attn_fwd(lay, x, vl, vr, slope: float, n_pad: int, flash: bool):
    """Attention forward on a fwd layout (see attn_fwd_reference): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(lay, x, vl, {"vr": vr}, n_pad)
    if x.shape[0] < lay.n_src or vr.shape != (n_pad, vl.shape[1]):
        raise ValueError(f"x needs >= {lay.n_src} rows (has {x.shape[0]}) and vr "
                         f"({n_pad}, {vl.shape[1]}) (is {tuple(vr.shape)})")
    if x.device.type == "cpu":
        return attn_fwd_reference(lay, x, vl, vr, slope, n_pad, flash)
    _cuda_only(x, "attn_fwd")
    lib = build().lib
    hf, nh = x.shape[1], vl.shape[1]
    out = torch.zeros((n_pad, hf), dtype=torch.float32, device=x.device)
    m = torch.zeros((n_pad, nh), dtype=torch.float32, device=x.device)
    s = torch.zeros_like(m)
    outpos = torch.zeros_like(out) if flash else None
    spos = torch.zeros_like(m) if flash else None
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    _launch("attn_fwd", lib.gala_attn_fwd_f32, x,
            x.data_ptr(), vl.data_ptr(), vr.data_ptr(), *_lay_ptrs(lay),
            out.data_ptr(), m.data_ptr(), s.data_ptr(), ptr(outpos), ptr(spos),
            lay.row_node.shape[0], hf, nh, float(slope), _vec(x, nh, out))
    return out, m, s, outpos, spos


def attn_bwd1(lay, x, vl, vr, dout, m, s, slope: float):
    """Backward pass 1 on a fwd layout (see attn_bwd1_reference)."""
    n_pad = dout.shape[0]
    _check(lay, x, vl, {"vr": vr, "dout": dout, "m": m, "s": s}, n_pad)
    nh = vl.shape[1]
    if (x.shape[0] < lay.n_src or dout.shape[1] != x.shape[1]
            or any(t.shape != (n_pad, nh) for t in (vr, m, s))):
        raise ValueError(f"x needs >= {lay.n_src} rows, dout (n_pad, hf) and vr, m, s "
                         "(n_pad, H)")
    if x.device.type == "cpu":
        return attn_bwd1_reference(lay, x, vl, vr, dout, m, s, slope)
    _cuda_only(x, "attn_bwd1")
    lib = build().lib
    sds, a, b = (torch.zeros((n_pad, nh), dtype=torch.float32, device=x.device)
                 for _ in range(3))
    _launch("attn_bwd1", lib.gala_attn_bwd1_f32, x,
            x.data_ptr(), vl.data_ptr(), vr.data_ptr(), dout.data_ptr(), m.data_ptr(),
            s.data_ptr(), *_lay_ptrs(lay), sds.data_ptr(), a.data_ptr(), b.data_ptr(),
            lay.row_node.shape[0], x.shape[1], nh, float(slope), _vec(x, nh, dout))
    return sds, a, b


def attn_bwd2(lay, x, vl, w_tab, slope: float, c_pad: int):
    """Backward pass 2 on a transpose layout (see attn_bwd2_reference):
    returns [dx | dvl] (c_pad, hf + H)."""
    _check(lay, x, vl, {"w_tab": w_tab}, c_pad)
    hf, nh = x.shape[1], vl.shape[1]
    if w_tab.shape[1] != hf + 4 * nh or w_tab.shape[0] < lay.n_src:
        raise ValueError(f"w_tab {tuple(w_tab.shape)} must be (>= {lay.n_src}, {hf + 4 * nh})")
    if x.shape[0] < lay.n_real:
        raise ValueError(f"x has {x.shape[0]} rows, the layout has {lay.n_real} source rows")
    if x.device.type == "cpu":
        return attn_bwd2_reference(lay, x, vl, w_tab, slope, c_pad)
    _cuda_only(x, "attn_bwd2")
    lib = build().lib
    out = torch.zeros((c_pad, hf + nh), dtype=torch.float32, device=x.device)
    _launch("attn_bwd2", lib.gala_attn_bwd2_f32, x,
            w_tab.data_ptr(), x.data_ptr(), vl.data_ptr(), *_lay_ptrs(lay), out.data_ptr(),
            lay.row_node.shape[0], hf, nh, float(slope), _vec(x, nh, w_tab))
    return out


# --------------------------------------------------------------------------- #
# kernels against plain versions (for the card's checks)
# --------------------------------------------------------------------------- #
def per_head_dot(a: torch.Tensor, b: torch.Tensor, nh: int) -> torch.Tensor:
    """(rows, H): <a, b> over each head's fh columns."""
    return (a * b).view(a.shape[0], nh, -1).sum(-1)


def compare_with_plain(ab, x, vl, vr, dout, slope: float, n_pad: int, c_pad: int) -> dict:
    """Run the three kernels and their plain versions on one AttnBell at
    the same CUDA inputs; returns {check: (max |kernel - plain|, elements
    out of tolerance)}.

    Tolerance per element, in f32: |kernel - plain| <= 1e-4 + 1e-4 * scale,
    where scale is the sum of the magnitudes of the terms (the plain
    version run on absolute values: P |x| for out, sum p |<dout, x>| for
    sds and A, sum p |dout| for dx, sum p (|dp| + |sds|) for dvl; the
    value itself where all terms are positive: s, s+, B).  The two sum in
    different orders, the kernel with an online softmax, and a sum's
    rounding error grows with its terms, not with its result.  m takes no
    sum and is held to 1e-4.  bwd1 is also held to the flash identity:
    sds = <dout, out> and A - sds B = (1 - slope)(<dout, out+> - sds s+)."""
    nh = vl.shape[1]
    res = {}

    def check(name, got, want, scale):
        err = (got - want).abs()
        res[name] = (err.max().item() if err.numel() else 0.0,
                     int((err > 1e-4 + 1e-4 * scale).sum()))

    out, m, s, outpos, spos = attn_fwd(ab.fwd, x, vl, vr, slope, n_pad, True)
    r_out, r_m, r_s, r_outpos, r_spos = attn_fwd_reference(ab.fwd, x, vl, vr, slope, n_pad, True)
    a_out, _, _, a_outpos, _ = attn_fwd_reference(ab.fwd, x.abs(), vl, vr, slope, n_pad, True)
    check("fwd out", out, r_out, a_out)
    check("fwd m", m, r_m, 0.0)
    check("fwd s", s, r_s, r_s)
    check("fwd out+", outpos, r_outpos, a_outpos)
    check("fwd s+", spos, r_spos, r_spos)

    sds, a, b = attn_bwd1(ab.fwd, x, vl, vr, dout, r_m, r_s, slope)
    r_sds, r_a, r_b = attn_bwd1_reference(ab.fwd, x, vl, vr, dout, r_m, r_s, slope)
    a_sds, _, _ = attn_bwd1_reference(ab.fwd, x.abs(), vl, vr, dout.abs(), r_m, r_s, slope)
    check("bwd1 sds", sds, r_sds, a_sds)
    check("bwd1 A", a, r_a, a_sds)
    check("bwd1 B", b, r_b, r_b)
    check("bwd1 sds = <dout, out>", sds, per_head_dot(dout, out, nh), a_sds)
    check("bwd1 A - sds B = flash identity", a - sds * b,
          (1.0 - slope) * (per_head_dot(dout, outpos, nh) - sds * spos), 2 * a_sds)

    w_tab = torch.cat([dout, vr, r_m, r_s, r_sds], dim=1)
    dxx = attn_bwd2(ab.t, x, vl, w_tab, slope, c_pad)
    r_dxx = attn_bwd2_reference(ab.t, x, vl, w_tab, slope, c_pad)
    a_tab = torch.cat([dout.abs(), vr, r_m, r_s, -r_sds.abs()], dim=1)
    a_dxx = attn_bwd2_reference(ab.t, x.abs(), vl, a_tab, slope, c_pad)
    hf = x.shape[1]
    check("bwd2 dx", dxx[:, :hf], r_dxx[:, :hf], a_dxx[:, :hf])
    check("bwd2 dvl", dxx[:, hf:], r_dxx[:, hf:], a_dxx[:, hf:])
    return res


def aggregate_scales(ab, x, vl, vr, dout, slope: float, n_pad: int, c_pad: int):
    """Magnitudes of the summed terms of attention_aggregate's out, dx, dvl
    and dvr (the gradients of sum(out * dout)), from the plain versions on
    absolute values, as compare_with_plain takes them: a result is held
    to 1e-4 + 1e-4 * its scale."""
    hf, nh = x.shape[1], vl.shape[1]
    _, m, s, _, spos = attn_fwd_reference(ab.fwd, x, vl, vr, slope, n_pad, True)
    a_out, _, _, a_outpos, _ = attn_fwd_reference(ab.fwd, x.abs(), vl, vr, slope, n_pad, True)
    a_sds = per_head_dot(dout.abs(), a_out, nh)
    a_tab = torch.cat([dout.abs(), vr, m, s, -a_sds], dim=1)
    a_dxx = attn_bwd2_reference(ab.t, x.abs(), vl, a_tab, slope, c_pad)
    a_dvr = (1.0 - slope) * (per_head_dot(dout.abs(), a_outpos, nh) + a_sds * spos)
    return a_out, a_dxx[:, :hf], a_dxx[:, hf:], a_dvr
