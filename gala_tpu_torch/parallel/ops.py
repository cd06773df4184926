"""Sharded graph ops on one rank's tensors (the port of gala_tpu.parallel.ops).

gala_tpu calls these inside shard_map, on per-shard arrays, and lets
autodiff transpose its collectives.  Here each rank calls them on its own
tensors (a ShardGraph's, parallel.graph) and the two collectives are
autograd Functions over the data process group (`group`):

    all_gather   (tiled) the feature matrix from every shard; backward
                 reduce_scatter (sum), this rank's slice of the summed
                 gradients: shard_map's psum_scatter.
    all_to_all   the (S, H, F) halo send block; backward the reverse
                 all_to_all.

Aggregations read remote sources through one of them: `spmd_spmm` and
`spmd_spmm_ev` gather the whole feature matrix; `spmd_spmm_halo` and the
bell forms exchange only the boundary rows.  The segment reductions are
index_add_ (gala_tpu uses XLA's segment_sum there, no Pallas kernel);
the bell forms run the SpMM kernel (ops.kernels.library) on the rank's
binned layouts over its gather table, the learned-value form adds the
SDDMM kernel, and `spmd_attention`'s bell branch runs the attention
kernels (ops.attention.attention_aggregate) on the rank's attention
layouts.  On CPU tensors every kernel runs its plain version.

Every rank of a group must call the same ops in the same order: the
collectives (and their gradients' collectives) pair up by order.  The
gloo backend takes CUDA tensors directly (torch 2.11 on an H100 host),
so there is one path for every backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from gala_tpu_torch.ops.attention import attention_aggregate
from gala_tpu_torch.ops.kernels import library


def _size(group) -> int:
    return dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        chunks = list(grad.contiguous().chunk(_size(ctx.group), dim=0))
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=ctx.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, group, pending):
        ctx.group = group
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send.contiguous(), group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return recv

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(S*r, ...) from every shard's (r, ...), in shard order."""
    return _AllGather.apply(x, group)


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """Block q of `send` (S, ...) goes to shard q; block p of the result
    came from shard p."""
    return _AllToAll.apply(send, group, None)


def all_to_all_start(send: torch.Tensor, group):
    """all_to_all issued without waiting: (recv, work).  recv holds the
    exchange only after work.wait(); work issued before the wait (the
    local partition's reduce) overlaps the exchange."""
    pending = []
    recv = _AllToAll.apply(send, group, pending)
    return recv, pending[0]


def _segment_sum(msg: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    return msg.new_zeros((n_seg,) + msg.shape[1:]).index_add(0, seg, msg)


def spmd_spmm(src, dst_local, vals, x_shard, rows_per_shard: int, group):
    """out_shard = (A @ X) rows owned by this shard; x_shard (r, F) local
    rows, src global ids into the gathered (S*r, F) matrix."""
    x_full = all_gather(x_shard, group)
    msg = vals[:, None] * x_full.index_select(0, src)
    return _segment_sum(msg, dst_local, rows_per_shard + 1)[:rows_per_shard]


def spmd_spmm_halo(src_halo, dst_local, vals, x_shard, send_idx, rows_per_shard: int,
                   n_shards: int, halo: int, edges_local: int, group):
    """out_shard = (A @ X) rows owned by this shard, exchanging only the
    boundary rows peers read (all_to_all) instead of the whole matrix.

    The edges come [local block | remote block] (ShardGraph.edges_local):
    the local block's gather and reduce do not read the exchange, so they
    are issued before its wait and run while it is in flight.  The remote
    block reads the received halo rows (its padding edges read halo row 0
    with value 0).  `vals` may be structural or learned (GAT): gradients
    flow to every operand."""
    f = x_shard.shape[1]
    r, el = rows_per_shard, edges_local
    send = x_shard.index_select(0, send_idx.reshape(-1)).view(n_shards, halo, f)
    recv, work = all_to_all_start(send, group)
    xp = torch.cat([x_shard, x_shard.new_zeros((1, f))], dim=0)
    msg_l = vals[:el, None] * xp.index_select(0, src_halo[:el])
    out = _segment_sum(msg_l, dst_local[:el], r + 1)
    work.wait()
    halo_tab = recv.view(n_shards * halo, f)
    msg_r = vals[el:, None] * halo_tab.index_select(0, src_halo[el:] - r)
    out = out + _segment_sum(msg_r, dst_local[el:], r + 1)
    return out[:r]


def _halo_table(g, rows):
    """The rank's [local | halo | zero] gather table (n_tab + 1 rows):
    each peer's boundary rows by all_to_all, then the zero row the bell
    layouts' pad slots read at n_tab.  The gradient of the halo rows goes
    back to their owners through the reverse all_to_all."""
    f = rows.shape[1]
    s, h = g.n_shards, g.halo
    send = rows.index_select(0, g.send_idx.reshape(-1)).view(s, h, f)
    recv = all_to_all(send, g.group)
    return torch.cat([rows, recv.view(s * h, f), rows.new_zeros((1, f))], dim=0)


def spmd_spmm_bell(g, x_shard):
    """Aggregation by the SpMM kernel on the rank's binned layout over its
    gather table; the backward runs it on the transpose layout (the op's
    registered gradient) and returns the halo rows' share to their
    owners."""
    tab = _halo_table(g, x_shard)
    r = g.rows_per_shard
    return library.spmm(tab, g.bell, g.t_bell, r + 1, tab.shape[0])[:r]


def spmd_spmm_ev_bell(g, evals, x_shard):
    """Aggregation with learned edge values (evals: the shard's (Es,)
    edge vector) on the binned layouts: ops.spmm.spmm_ev_bell, the SpMM
    kernel with per-slot values, its transpose for dx and the SDDMM
    kernel for devals."""
    from gala_tpu_torch.ops.spmm import spmm_ev_bell

    tab = _halo_table(g, x_shard)
    r = g.rows_per_shard
    return spmm_ev_bell(evals, tab, g.bell, g.t_bell, g.ev, r + 1, tab.shape[0])[:r]


def spmd_spmm_ev(src, dst_local, evals, x_shard, rows_per_shard: int, group):
    """SpMM with learned edge values (GAT), over the gathered matrix."""
    return spmd_spmm(src, dst_local, evals, x_shard, rows_per_shard, group)


def _edge_vectors(src, dst_local, vl_shard, vr_shard, group):
    vl_full = all_gather(vl_shard, group)
    vr_pad = torch.cat([vr_shard, vr_shard.new_zeros((1, 1))], dim=0)
    return vl_full[:, 0].index_select(0, src), vr_pad[:, 0].index_select(0, dst_local)


def spmd_sddvv_add(src, dst_local, vl_shard, vr_shard, rows_per_shard: int, group):
    """Per-edge vl[src] + vr[dst]; vl gathered from every shard, vr local
    (padding edges read its appended zero row r)."""
    a, b = _edge_vectors(src, dst_local, vl_shard, vr_shard, group)
    return a + b


def spmd_sddvv_mul(src, dst_local, vl_shard, vr_shard, rows_per_shard: int, group):
    """Per-edge vl[src] * vr[dst]: the sparsity rewrite's norm_src *
    norm_dst edge values."""
    a, b = _edge_vectors(src, dst_local, vl_shard, vr_shard, group)
    return a * b


def spmd_attention(g, x_shard, vl_shard, vr_shard, slope: float):
    """Sharded fused attention: one exchange of the [x | vl] rows serves
    the scores and the aggregation; each destination's softmax is local
    (destination partitioning keeps a softmax row on one shard).  With
    the rank's attention layouts (g.attn) the attention kernels run the
    single-device op over its gather table; without them the unfused
    chain runs head by head (H <= 8) on the edge lists, after a halo
    all_to_all or an all_gather."""
    hf = x_shard.shape[1]
    nh = vl_shard.shape[1]
    fh = hf // nh
    r = g.rows_per_shard
    f = hf + nh
    vr_pad = torch.cat([vr_shard, vr_shard.new_zeros((1, nh))], dim=0)
    xx = torch.cat([x_shard, vl_shard.to(x_shard.dtype)], dim=1)
    if g.attn is not None:
        tab = _halo_table(g, xx)
        out = attention_aggregate(r + 1, tab.shape[0], slope, g.attn, tab[:, :hf], tab[:, hf:],
                                  vr_pad)
        return out[:r]
    if g.use_halo:
        el = g.edges_local
        send = xx.index_select(0, g.send_idx.reshape(-1)).view(g.n_shards, g.halo, f)
        recv = all_to_all(send, g.group)
        xp = torch.cat([xx, xx.new_zeros((1, f))], dim=0)
        rows_l = xp.index_select(0, g.src_halo[:el])
        rows_r = recv.view(-1, f).index_select(0, g.src_halo[el:] - r)
        rows = torch.cat([rows_l, rows_r], dim=0)  # block order == edge order
    else:
        rows = all_gather(xx, g.group).index_select(0, g.src)
    outs = []
    for h in range(nh):
        z = rows[:, hf + h].float() + vr_pad[:, h].index_select(0, g.dst_local)
        z = torch.where(z > 0, z, slope * z)
        p = spmd_edge_softmax(g.dst_local, z, g.occ, r)
        outs.append(_segment_sum(p[:, None].to(x_shard.dtype) * rows[:, h * fh : (h + 1) * fh],
                                 g.dst_local, r + 1)[:r])
    return torch.cat(outs, dim=1) if nh > 1 else outs[0]


def spmd_edge_softmax(dst_local, logits, vals, rows_per_shard: int):
    """Softmax over each local destination's incoming edges (the edges of
    one destination never cross shards).  The per-destination max is a
    constant of the gradient (the softmax does not depend on it), as in
    the single-device op."""
    n_seg = rows_per_shard + 1
    idx = dst_local.long()
    m = logits.new_full((n_seg,), float("-inf")).scatter_reduce(0, idx, logits.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = torch.exp(logits - m.index_select(0, idx))
    z = torch.where(vals != 0, z, torch.zeros_like(z))  # mask padded edges
    s = _segment_sum(z, idx, n_seg)
    s = torch.where(s > 0, s, torch.ones_like(s))
    return z / s.index_select(0, idx)
