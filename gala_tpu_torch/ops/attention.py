"""Fused slot-space graph attention (the port of gala_tpu.ops.attention).

One op, `attention_aggregate`, replaces the edge-centric GAT chain
(SDDVV-add logits, leaky-relu, per-destination edge softmax, SpMM with
the softmax values).  Head h of edge c -> r scores
z = leaky_relu(vl[c, h] + vr[r, h]); a masked softmax runs over each
destination's slots; out[r, h*fh:(h+1)*fh] = sum_c p * x[c, h*fh:(h+1)*fh].

The layout is gala_tpu's: a binned ELL of the graph with occupancy values
(1.0 per real edge) and no diagonal split, plus the same of the transpose
(`build_attention_bell`).  On the device each is a BellDev with per-row
descriptors, so a hub node is one contiguous row that the kernels walk
whole: gala_tpu's `rows` / `t_rows` gathers and its hub segment merge
have no counterpart.

Forward and backward keep the maths of gala_tpu's default (the XLA
chunked executor, `_attn_fwd_chunked` / `_attn_bwd_chunked` with the
flash identity): the forward also emits out+ = sum_{zpre>0} p x and
s+ = sum_{zpre>0} p per destination, and the backward gets
sds = <dout, out> and dvr = (1 - slope)(<dout, out+> - sds s+) from
node-sized tensors, then runs one sweep over the transpose layout
(gala_tpu's `_attn_bwd_pass2`).  The sweeps are the kernels of
ops.kernels.attn_bell (fwd and bwd2; bwd1 is gala_tpu's pass 1, which
this identity replaces).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gala_tpu_torch.data.csr import HostCSR
from gala_tpu_torch.data.ell import build_binned_ell
from gala_tpu_torch.ops.graph import BellDev
from gala_tpu_torch.ops.kernels.attn_bell import attn_bwd2, attn_fwd, per_head_dot


# --------------------------------------------------------------------------- #
# host build
# --------------------------------------------------------------------------- #
def build_attention_bell(g: HostCSR):
    """(forward layout, transpose layout), gala_tpu's build.

    Self loops stay in the layout (GAT attends over neighbours and self).
    The layouts carry OCCUPANCY values (1.0 per real edge): scores ignore
    edge weights and the values serve only as slot masks, so a real edge
    whose weight is exactly 0.0 still takes part in the softmax."""
    occ = np.ones_like(g.vals, dtype=np.float32)
    g1 = dataclasses.replace(g, vals=occ)
    hb = build_binned_ell(g1, split_diag=False)

    order_t = np.argsort(g.src, kind="stable")
    counts = np.bincount(g.src, minlength=g.n_cols)
    rp = np.zeros(g.n_cols + 1, np.int64)
    np.cumsum(counts, out=rp[1:])
    gt = HostCSR(
        n_rows=g.n_cols, n_cols=g.n_rows, row_ptr=rp,
        dst=g.src[order_t].astype(np.int32),
        src=g.dst[order_t].astype(np.int32),
        vals=occ,
    )
    hbt = build_binned_ell(gt, split_diag=False)
    return hb, hbt


@dataclasses.dataclass
class AttnBell:
    """Device tensors of the fused-attention layout: `fwd` (rows =
    destinations) and `t` (rows = sources)."""

    fwd: BellDev
    t: BellDev

    @classmethod
    def from_host(cls, g: HostCSR, n_pad: int, c_pad: int, device) -> "AttnBell":
        hb, hbt = build_attention_bell(g)
        return cls(
            fwd=BellDev.from_host(hb, n_pad, g.n_rows, device),
            t=BellDev.from_host(hbt, c_pad, g.n_cols, device),
        )


# --------------------------------------------------------------------------- #
# device op
# --------------------------------------------------------------------------- #
class AttentionAggregate(torch.autograd.Function):
    """out = attention aggregation; the gradient of (x, vl, vr) by the
    flash identity and the bwd2 sweep on the transpose layout."""

    @staticmethod
    def forward(ctx, x, vl, vr, ab: AttnBell, n_pad: int, c_pad: int, slope: float,
                flash: bool):
        out, m, s, outpos, spos = attn_fwd(ab.fwd, x, vl, vr, slope, n_pad, flash)
        if flash:
            ctx.save_for_backward(x, vl, vr, m, s, out, outpos, spos)
            ctx.ab, ctx.c_pad, ctx.slope = ab, c_pad, slope
        return out

    @staticmethod
    def backward(ctx, dout):
        x, vl, vr, m, s, out, outpos, spos = ctx.saved_tensors
        dout = dout.contiguous()
        nh = vl.shape[1]
        sds = per_head_dot(dout, out, nh)
        dvr = (1.0 - ctx.slope) * (per_head_dot(dout, outpos, nh) - sds * spos)
        w_tab = torch.cat([dout, vr, m, s, sds], dim=1)
        dxx = attn_bwd2(ctx.ab.t, x, vl, w_tab, ctx.slope, ctx.c_pad)
        hf = x.shape[1]
        return dxx[:, :hf], dxx[:, hf:], dvr, None, None, None, None, None


def attention_aggregate(n_pad: int, c_pad: int, slope: float, ab: AttnBell,
                        x: torch.Tensor, vl: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    """Softmax-attention aggregation, H heads in one sweep (gala_tpu's
    signature).  x: (c_pad, H*fh), vl: (c_pad, H), vr: (n_pad, H); H is
    inferred from vl (H = 1 is the DSL GAT).  Returns (n_pad, H*fh).

    The forward emits the flash statistics only when a gradient is wanted
    (they double the weighted reduce)."""
    flash = torch.is_grad_enabled() and any(t.requires_grad for t in (x, vl, vr))
    return AttentionAggregate.apply(x.contiguous(), vl.contiguous(), vr.contiguous(), ab,
                                    n_pad, c_pad, float(slope), flash)
