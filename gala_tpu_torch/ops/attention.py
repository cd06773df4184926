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
this identity replaces), reached through the custom op
`gala_tpu_torch::attn_fwd`, whose registered gradient calls
`gala_tpu_torch::attn_bwd2` (ops.kernels.library).

bf16 activations, as gala_tpu runs them: x, vl and vr enter the kernels
in x's dtype (vl and vr cast to it, as gala_tpu stages vl.astype(x.dtype)
beside x); the kernels return f32 and the op returns out in x's dtype,
while the backward's residual is the f32 out (gala_tpu's out32_node), so
sds = <dout, out> is taken before the rounding.  The backward tables,
dvr and the gradients are f32 and are cast back to the inputs' dtypes.

Under a profiler (utils.profiling) `attention_aggregate` is the span
`gala.attention` and counts its work under that name: the layout's real
destination rows and nonzeros (AttnBell.n_rows, n_edges), x's width, the
heads and x's item size; its gradient is `gala.attention.grad`, counted
with the real source rows (AttnBell.n_cols).

The GAT paper's heads around it (the DSL's gat_heads): `head_scores`,
each head's score from its own columns, `head_mean`, the output layer's
mean over heads, and `elu`; spans `gala.head_scores`, `gala.head_mean`
and `gala.elu` (their forwards), which count no work (the benchmark's
head_ops_ms reads their spans alone).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from gala_tpu_torch.data.csr import HostCSR
from gala_tpu_torch.data.ell import build_binned_ell
from gala_tpu_torch.models.common import full_precision_matmuls
from gala_tpu_torch.ops.graph import BellDev, moved
from gala_tpu_torch.ops.kernels import library
from gala_tpu_torch.utils.profiling import count, marker, recording


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
    destinations) and `t` (rows = sources), and the graph's real edge
    count (0 where the builder gave none)."""

    fwd: BellDev
    t: BellDev
    n_edges: int = 0

    @property
    def n_rows(self) -> int:
        """Real destination rows."""
        return self.fwd.n_real

    @property
    def n_cols(self) -> int:
        """Real source rows."""
        return self.t.n_real

    @classmethod
    def from_host(cls, g: HostCSR, n_pad: int, c_pad: int, device,
                  col_tile: int = 0) -> "AttnBell":
        """col_tile: column tiling of both layouts (ops.graph)."""
        hb, hbt = build_attention_bell(g)
        return cls(
            fwd=BellDev.from_host(hb, n_pad, g.n_rows, device, col_tile),
            t=BellDev.from_host(hbt, c_pad, g.n_cols, device, col_tile),
            n_edges=int(g.n_edges),
        )

    def to(self, device, memo: dict | None = None) -> "AttnBell":
        memo = {} if memo is None else memo
        return dataclasses.replace(self, fwd=moved(self.fwd, device, memo),
                                   t=moved(self.t, device, memo))


# --------------------------------------------------------------------------- #
# device op
# --------------------------------------------------------------------------- #
def attention_aggregate(n_pad: int, c_pad: int, slope: float, ab: AttnBell,
                        x: torch.Tensor, vl: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    """Softmax-attention aggregation, H heads in one sweep (gala_tpu's
    signature).  x: (c_pad, H*fh), vl: (c_pad, H), vr: (n_pad, H); H is
    inferred from vl (H = 1 is the DSL GAT).  Returns (n_pad, H*fh) in
    x's dtype (float32 or bfloat16; vl and vr are cast to it).

    The forward emits the flash statistics only when a gradient is wanted
    (they double the weighted reduce)."""
    with marker("gala.attention"):
        grad_work = None
        if recording():
            work = {"nnz": ab.n_edges, "width": int(x.shape[1]), "heads": int(vl.shape[1]),
                    "itemsize": x.element_size()}
            count("gala.attention", rows=ab.n_rows, **work)
            grad_work = {"rows": ab.n_cols, **work}
        flash = torch.is_grad_enabled() and any(t.requires_grad for t in (x, vl, vr))
        vl, vr = (t.to(x.dtype).contiguous() for t in (vl, vr))
        out = library.attention(x.contiguous(), vl, vr, ab, n_pad, c_pad, float(slope), flash,
                                grad_work if flash else None)
        return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# GAT-form heads
# --------------------------------------------------------------------------- #
def head_scores(p, x: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, H) scores, score[n, h] = x[n, h*fh:(h+1)*fh] @ w[:, h] + b[h],
    from p = {"w": (fh, H), "b": (H,)}: one product of x with the
    block-diagonal (H*fh, H) matrix that holds w's columns, so x is read
    once and not copied per head."""
    with marker("gala.head_scores"):
        full_precision_matmuls()
        w = p["w"].to(x.dtype)
        eye = torch.eye(heads, dtype=x.dtype, device=x.device)
        block = (w.t()[:, :, None] * eye[:, None, :]).reshape(-1, heads)
        return torch.matmul(x, block) + p["b"].to(x.dtype)


def head_mean(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, H*C) -> (N, C): the mean over the H heads of C columns each."""
    with marker("gala.head_mean"):
        return x.view(x.shape[0], heads, -1).mean(dim=1)


def elu(x: torch.Tensor, heads: int = 1) -> torch.Tensor:
    """ELU (alpha 1) of the layer's output; `heads`, the argument every
    TRANSFORM node passes (lowering.interp), does not change it."""
    with marker("gala.elu"):
        return F.elu(x)
