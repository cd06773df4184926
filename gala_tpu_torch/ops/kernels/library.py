"""The hand kernels as `torch.library` custom ops: one binding that the
trainer, `torch.export` and the loaded artifact all go through.

A custom op takes only tensors and Python scalars, so a row-descriptor
layout (ops.graph.BellDev or SlotRows, with its WorkUnits) crosses the
op boundary flattened by `layout_args` into the tensors the kernels
already read by pointer (`Tensor[]`) and its sizes (`int[]`);
`layout_of` rebuilds the layout object on the other side.  Optional
tensors (diag, out_index, big_vrow, perm, mask) are left out of the list
where absent and named by a bit mask among the ints.

The ops, under the namespace `gala_tpu_torch`:

    bell_spmm(x, lay, lay_ints, vals, n_out, t_lay, t_ints, c_out)
        out = A @ x (ops.kernels.bell_spmm); its gradient is the same op
        on the transpose layout `t_lay`, whose own transpose is `lay`.
        With per-slot `vals` it has no gradient of its own (spmm_ev and
        ops.spmm.SampledSpmm differentiate those products).
    spmm_ev(evals, x, lay, lay_ints, t_lay, t_ints, src, dst, n_out, c_out)
        out = A(evals) @ x, learned per-edge values placed in the slots;
        dx is bell_spmm on the transpose with its permuted values, devals
        the SDDMM <x[src], dz[dst]>, each only where a gradient is wanted.
    sddmm(src, dst, a, b)            (ops.kernels.sddmm)
    attn_fwd(x, vl, vr, lay, lay_ints, t_lay, t_ints, slope, n_pad, c_pad, flash)
        -> (out, m, s, outpos, spos)  (ops.kernels.attn_bell); outpos and
        spos are (0, ...) tensors unless `flash`.  Its gradient (of out)
        is the flash identity and bwd2 on `t_lay`; it needs flash = True.
    attn_bwd2(x, vl, w_tab, lay, lay_ints, slope, c_pad)

The ops are defined on a `torch.library.Library` (define and impl, not
the `custom_op` decorator, whose Python wrapper costs tens of µs a call
on these list-taking schemas).  Each kernel op has one implementation,
registered under the CPU and the CUDA keys: it rebuilds the layout and
calls its kernel module's public function (ops.kernels.bell_spmm
.bell_spmm, sddmm.sddmm, attn_bell.attn_fwd, attn_bell.attn_bwd2), the
one binding, which checks the arguments and runs the plain version on
CPU tensors and the kernel (the ctypes launch, which counts its
launches) on CUDA tensors; a CUDA tensor never reaches a plain version.
spmm_ev is a composite of the SpMM op and plain torch.  Each op has a
fake form (register_fake) that gives its outputs' shapes and dtypes from
the scalar arguments, so export traces it without running anything and
no launch is counted.  The differentiable ops (bell_spmm, spmm_ev,
attn_fwd) have an Autograd kernel (`_register_gradient`), so a program
exported with them back-propagates after loading.

The gradients of bell_spmm and attn_fwd are the spans `gala.spmm.grad`
and `gala.attention.grad` (utils.profiling), each counting the work
that its forward's caller attached to the gradient's node (`spmm` and
`attention`'s `grad_work`, under a profiler only).

Importing this module registers the ops; it builds and loads no CUDA
library (that happens at the first CUDA call).  The kernels that have no
op, only their binding: bwd1 (off the path: the flash identity replaces
it), the row gather (minibatch SAGE, which is not exported) and the
SpMM's sampled form (bell_spmm_sampled; dynamic sampling refuses export).
"""
from __future__ import annotations

import torch

from gala_tpu_torch.ops.graph import PACKED_LANES, BellDev, SlotRows, WorkUnits, bin_views
from gala_tpu_torch.ops.kernels import attn_bell as _attn
from gala_tpu_torch.ops.kernels import bell_spmm as _spmm
from gala_tpu_torch.ops.kernels import sddmm as _sddmm
from gala_tpu_torch.ops.kernels._build import wide
from gala_tpu_torch.utils.profiling import count, marker

NAMESPACE = "gala_tpu_torch"

_UNIT_FIELDS = ("start", "length", "node", "part", "split_node", "split_first", "split_count",
                "warp_first")
_OPTIONAL = ("diag", "out_index", "big_vrow", "perm", "mask")
_BELL, _SLOTS = 0, 1


# --------------------------------------------------------------------------- #
# layouts across the op boundary
# --------------------------------------------------------------------------- #
def layout_args(lay) -> tuple[list[torch.Tensor], list[int]]:
    """(tensors, ints) of a BellDev or SlotRows: what its ops take."""
    u = lay.units
    tensors = [lay.flat_cols, lay.flat_vals, lay.row_start, lay.row_len, lay.row_node,
               *(getattr(u, f) for f in _UNIT_FIELDS)]
    present = 0
    for bit, name in enumerate(_OPTIONAL):
        t = getattr(lay, name, None)
        if t is not None:
            tensors.append(t)
            present |= 1 << bit
    ints = [_BELL if isinstance(lay, BellDev) else _SLOTS, present, lay.n_real, lay.n_src,
            u.n_partials, u.n_written, *u.warp_off]
    if isinstance(lay, BellDev):
        big_k = lay.big_vals.shape[1] if lay.n_big else 0
        ints += [lay.n_big, big_k, len(lay.bin_ks), *lay.bin_ks, *lay.bin_counts]
    else:
        ints.append(lay.k)
    return tensors, ints


def _check_packing(kind, present, tensors, ints, n_unit, warp_off, unit) -> None:
    """Raise unless (tensors, ints) hold as many of each as layout_args
    packs for this kind and these optional fields, and the warp tables'
    offsets span warp_first: a layout packed another way (an older
    artifact's) would hand the kernels garbage tables."""
    n_tensors = 5 + n_unit + bin(present).count("1")
    if kind == _BELL:
        n_ints = 8 + 2 * ints[7] if len(ints) > 7 else None
    else:
        n_ints = 6 if kind == _SLOTS else None
    ok = (n_ints == len(ints) and len(tensors) == n_tensors
          and len(warp_off) == PACKED_LANES + 1 and warp_off[0] == 0
          and all(a <= b for a, b in zip(warp_off, warp_off[1:]))
          and warp_off[-1] == unit[-1].numel() and unit[-1].dtype == torch.int32)
    if not ok:
        raise ValueError(f"layout packed with {len(tensors)} tensors and "
                         f"{len(ints) + len(warp_off) + 1} ints does not match this version's "
                         "packing; export it again")


def layout_of(tensors: list[torch.Tensor], ints: list[int], views: bool = True):
    """The BellDev or SlotRows that layout_args flattened (no host
    slot_order).  A BellDev's bins are views of flat_vals that only the
    plain version reads; views=False leaves them empty (the kernels read
    flat_vals)."""
    kind, present, n_real, n_src, n_partials, n_written = ints[:6]
    n_off = PACKED_LANES + 1
    warp_off, ints = tuple(ints[6 : 6 + n_off]), ints[:5] + ints[6 + n_off :]
    cols, vals, row_start, row_len, row_node = tensors[:5]
    n_unit = len(_UNIT_FIELDS)
    unit = tensors[5 : 5 + n_unit]
    _check_packing(kind, present, tensors, ints, n_unit, warp_off, unit)
    units = WorkUnits(*unit, n_units=unit[0].shape[0], n_partials=n_partials, warp_off=warp_off,
                      n_written=n_written)
    rest = iter(tensors[5 + n_unit :])
    opt = {name: next(rest) if present >> bit & 1 else None for bit, name in enumerate(_OPTIONAL)}
    if kind == _SLOTS:
        return SlotRows(flat_cols=cols, flat_vals=vals, perm=opt["perm"], mask=opt["mask"],
                        row_start=row_start, row_len=row_len, row_node=row_node, units=units,
                        k=ints[5], n_real=n_real, n_src=n_src)
    n_big, big_k, n_bins = ints[5:8]
    bin_ks, bin_counts = tuple(ints[8 : 8 + n_bins]), tuple(ints[8 + n_bins : 8 + 2 * n_bins])
    bin_vals, big_vals = ((), None)
    if views:
        bin_vals, big_vals = bin_views(vals, bin_ks, bin_counts, n_big, big_k)
    return BellDev(flat_cols=cols, flat_vals=vals, bin_vals=bin_vals, big_vals=big_vals,
                   big_vrow=opt["big_vrow"], diag=opt["diag"], out_index=opt["out_index"],
                   row_start=row_start, row_len=row_len, row_node=row_node, units=units,
                   bin_ks=bin_ks, bin_counts=bin_counts, n_big=n_big, n_real=n_real,
                   n_src=n_src)


# --------------------------------------------------------------------------- #
# registration
# --------------------------------------------------------------------------- #
_LIB = torch.library.Library(NAMESPACE, "DEF")  # lives as long as the module


def _define(schema: str, fake, impl, keys: tuple[str, ...] = ("CPU", "CUDA")):
    """Define op `schema` with its one implementation `impl`, registered
    under each of `keys` (a composite of other ops under
    CompositeExplicitAutograd, for every device), and its fake form;
    returns the op."""
    name = schema[: schema.index("(")]
    _LIB.define(schema)
    for key in keys:
        _LIB.impl(name, impl, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _below_autograd(op, *args):
    """op(*args) dispatched straight to its device's implementation."""
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)


def _call(op, *args):
    """op(*args) from a gradient's forward or backward: below autograd
    unless grad mode is on (a backward with create_graph), which saves a
    dispatch through the op's Autograd kernel."""
    return op(*args) if torch.is_grad_enabled() else _below_autograd(op, *args)


def _register_gradient(op, function, differentiable: tuple[int, ...]) -> None:
    """The op's Autograd kernel: `function` (a torch.autograd.Function over
    the op's arguments) where grad mode is on and an argument at one of
    the `differentiable` positions requires a gradient, else the op below
    autograd.  This is torch.library.register_autograd's mechanism
    without its generic argument handling, which added ~320 µs of host
    time to each forward and backward of the SpMM op on an H100
    machine's host (scripts/op_dispatch_torch.py)."""
    def kernel(*args):
        if torch.is_grad_enabled() and any(args[i] is not None and args[i].requires_grad
                                           for i in differentiable):
            return function.apply(*args)
        return _below_autograd(op, *args)

    _LIB.impl(op._schema.name.split("::")[1], kernel, "Autograd")


# --------------------------------------------------------------------------- #
# bell_spmm
# --------------------------------------------------------------------------- #
def _bell_spmm(x, lay, lay_ints, vals, n_out, t_lay, t_ints, c_out):
    layout = layout_of(lay, lay_ints, views=x.device.type == "cpu")
    return _spmm.bell_spmm(layout, x, n_out, vals)


def _bell_spmm_fake(x, lay, lay_ints, vals, n_out, t_lay, t_ints, c_out):
    return x.new_empty((n_out, x.shape[1]))


bell_spmm_op = _define(
    "bell_spmm(Tensor x, Tensor[] lay, int[] lay_ints, Tensor? vals, int n_out, "
    "Tensor[] t_lay, int[] t_ints, int c_out) -> Tensor",
    _bell_spmm_fake, _bell_spmm)


class _BellSpmmGrad(torch.autograd.Function):
    """dx = A^T dz: the op on the transpose layout, whose transpose is `lay`
    (so the gradient has a gradient too)."""

    @staticmethod
    def forward(ctx, x, lay, lay_ints, vals, n_out, t_lay, t_ints, c_out):
        if vals is not None:
            raise RuntimeError("bell_spmm with per-slot values has no gradient of its own: "
                               "spmm_ev and SampledSpmm differentiate those products")
        if not t_lay:
            raise RuntimeError("bell_spmm was called without its transpose layout: no gradient")
        ctx.args = (lay, lay_ints, n_out, t_lay, t_ints, c_out)
        return _call(bell_spmm_op, x, lay, lay_ints, vals, n_out, t_lay, t_ints, c_out)

    @staticmethod
    def backward(ctx, dz):
        lay, lay_ints, n_out, t_lay, t_ints, c_out = ctx.args
        with marker("gala.spmm.grad"):
            _count_grad(ctx, "gala.spmm.grad")
            dx = _call(bell_spmm_op, dz.contiguous(), t_lay, t_ints, None, c_out, lay, lay_ints,
                       n_out)
        return dx, None, None, None, None, None, None, None


_register_gradient(bell_spmm_op, _BellSpmmGrad, (0,))


def _attach_work(out: torch.Tensor, grad_work: dict | None) -> None:
    """Hand `grad_work` to the gradient that will run for `out` (the
    autograd Function's node is its ctx)."""
    if grad_work is not None and out.grad_fn is not None:
        out.grad_fn.grad_work = grad_work


def _count_grad(ctx, name: str) -> None:
    work = getattr(ctx, "grad_work", None)
    if work is not None:
        count(name, **work)


def spmm(x: torch.Tensor, lay, t_lay, n_out: int, c_out: int,
         grad_work: dict | None = None) -> torch.Tensor:
    """out = A @ x on `lay`, differentiable in x through `t_lay` (A^T);
    its gradient counts `grad_work` under `gala.spmm.grad`."""
    out = bell_spmm_op(x, *layout_args(lay), None, n_out, *layout_args(t_lay), c_out)
    _attach_work(out, grad_work)
    return out


# --------------------------------------------------------------------------- #
# sddmm
# --------------------------------------------------------------------------- #
sddmm_op = _define("sddmm(Tensor src, Tensor dst, Tensor a, Tensor b) -> Tensor",
                   lambda src, dst, a, b: a.new_empty((src.shape[0],)), _sddmm.sddmm)


def sddmm_edges(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product <a[src[e]], b[dst[e]]> in the operands'
    promoted dtype (gala_tpu's sddmm_edges)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return sddmm_op(src, dst, a.to(dtype).contiguous(), b.to(dtype).contiguous())


# --------------------------------------------------------------------------- #
# spmm_ev: learned edge values
# --------------------------------------------------------------------------- #
def _spmm_ev(evals, x, lay, lay_ints, t_lay, t_ints, src, dst, n_out, c_out):
    vals = layout_of(lay, lay_ints, views=False).slot_values(evals.float())
    return bell_spmm_op(x, lay, lay_ints, vals, n_out, [], [], 0)


spmm_ev_op = _define(
    "spmm_ev(Tensor evals, Tensor x, Tensor[] lay, int[] lay_ints, Tensor[] t_lay, "
    "int[] t_ints, Tensor src, Tensor dst, int n_out, int c_out) -> Tensor",
    lambda evals, x, *args: x.new_empty((args[-2], x.shape[1])), _spmm_ev,
    keys=("CompositeExplicitAutograd",))


class _SpmmEvGrad(torch.autograd.Function):
    """dx: the SpMM on the transpose layout with the values permuted into
    its slots; devals: the SDDMM <x[src], dz[dst]>, in forward edge
    order.  Each only where its input wants a gradient."""

    @staticmethod
    def forward(ctx, evals, x, lay, lay_ints, t_lay, t_ints, src, dst, n_out, c_out):
        ctx.save_for_backward(evals, x)
        ctx.args = (t_lay, t_ints, src, dst, c_out)
        return _call(spmm_ev_op, evals, x, lay, lay_ints, t_lay, t_ints, src, dst, n_out, c_out)

    @staticmethod
    def backward(ctx, dz):
        evals, x = ctx.saved_tensors
        t_lay, t_ints, src, dst, c_out = ctx.args
        dz = dz.contiguous()
        devals = dx = None
        if ctx.needs_input_grad[0]:
            devals = sddmm_edges(src, dst, x, dz).to(evals.dtype)
        if ctx.needs_input_grad[1]:
            vals = layout_of(t_lay, t_ints, views=False).slot_values(evals.float())
            dx = _call(bell_spmm_op, dz, t_lay, t_ints, vals, c_out, [], [], 0)
        return devals, dx, None, None, None, None, None, None, None, None


_register_gradient(spmm_ev_op, _SpmmEvGrad, (0, 1))


def spmm_ev(evals: torch.Tensor, x: torch.Tensor, lay, t_lay, src: torch.Tensor,
            dst: torch.Tensor, n_out: int, c_out: int) -> torch.Tensor:
    """out = A(evals) @ x on a SlotRows layout, differentiable in evals
    and x."""
    return spmm_ev_op(evals, x, *layout_args(lay), *layout_args(t_lay), src, dst, n_out, c_out)


# --------------------------------------------------------------------------- #
# attention forward and bwd2
# --------------------------------------------------------------------------- #
def _flash_outputs(out, m, s, outpos, spos):
    """The forward's five outputs, outpos and spos (0, ...) when absent."""
    if outpos is None:
        outpos, spos = out.new_empty((0, out.shape[1])), m.new_empty((0, m.shape[1]))
    return out, m, s, outpos, spos


def _attn_fwd(x, vl, vr, lay, lay_ints, t_lay, t_ints, slope, n_pad, c_pad, flash):
    layout = layout_of(lay, lay_ints, views=x.device.type == "cpu")
    return _flash_outputs(*_attn.attn_fwd(layout, x, vl, vr, slope, n_pad, flash))


def _attn_fwd_fake(x, vl, vr, lay, lay_ints, t_lay, t_ints, slope, n_pad, c_pad, flash):
    hf, nh = x.shape[1], vl.shape[1]
    rows = n_pad if flash else 0
    f32 = torch.float32
    return (x.new_empty((n_pad, hf), dtype=f32), x.new_empty((n_pad, nh), dtype=f32),
            x.new_empty((n_pad, nh), dtype=f32), x.new_empty((rows, hf), dtype=f32),
            x.new_empty((rows, nh), dtype=f32))


attn_fwd_op = _define(
    "attn_fwd(Tensor x, Tensor vl, Tensor vr, Tensor[] lay, int[] lay_ints, Tensor[] t_lay, "
    "int[] t_ints, float slope, int n_pad, int c_pad, bool flash) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _attn_fwd_fake, _attn_fwd)


def _attn_bwd2(x, vl, w_tab, lay, lay_ints, slope, c_pad):
    layout = layout_of(lay, lay_ints, views=x.device.type == "cpu")
    return _attn.attn_bwd2(layout, x, vl, w_tab, slope, c_pad)


attn_bwd2_op = _define(
    "attn_bwd2(Tensor x, Tensor vl, Tensor w_tab, Tensor[] lay, int[] lay_ints, float slope, "
    "int c_pad) -> Tensor",
    lambda x, vl, w_tab, lay, lay_ints, slope, c_pad: x.new_empty(
        (c_pad, x.shape[1] + vl.shape[1]), dtype=torch.float32),
    _attn_bwd2)


class _AttnFwdGrad(torch.autograd.Function):
    """The gradient of out by the flash identity: sds = <dout, out> and
    dvr = (1 - slope)(<dout, out+> - sds s+) from node-sized tensors,
    then one bwd2 sweep over the transpose layout for [dx | dvl].  Needs
    the flash statistics (flash = True).  x is saved unpadded; on CUDA
    tensors bwd2 pads it again, and bwd2_table writes its table's dout
    block at the kernel's row pitch on either device."""

    @staticmethod
    def forward(ctx, x, vl, vr, lay, lay_ints, t_lay, t_ints, slope, n_pad, c_pad, flash):
        if not flash:
            raise RuntimeError("attn_fwd without its flash statistics (flash=False) has no "
                               "gradient")
        outs = _call(attn_fwd_op, x, vl, vr, lay, lay_ints, t_lay, t_ints, slope, n_pad, c_pad,
                     flash)
        out, m, s, outpos, spos = outs
        ctx.save_for_backward(x, vl, vr, *outs)
        ctx.mark_non_differentiable(m, s, outpos, spos)
        ctx.args = (t_lay, t_ints, slope, c_pad)
        return outs

    @staticmethod
    def backward(ctx, dout, *_stats):
        with marker("gala.attention.grad"):
            _count_grad(ctx, "gala.attention.grad")
            x, vl, vr, out, m, s, outpos, spos = ctx.saved_tensors
            t_lay, t_ints, slope, c_pad = ctx.args
            dout = wide(dout)
            nh = vl.shape[1]
            sds = _attn.per_head_dot(dout, out, nh)
            dvr = (1.0 - slope) * (_attn.per_head_dot(dout, outpos, nh) - sds * spos)
            w_tab = _attn.bwd2_table(x, dout, vr, m, s, sds)
            dxx = attn_bwd2_op(x, vl, w_tab, t_lay, t_ints, slope, c_pad)
            hf = x.shape[1]
            return (dxx[:, :hf].to(x.dtype), dxx[:, hf:].to(vl.dtype), dvr.to(vr.dtype),
                    None, None, None, None, None, None, None, None)


_register_gradient(attn_fwd_op, _AttnFwdGrad, (0, 1, 2))


def attention(x: torch.Tensor, vl: torch.Tensor, vr: torch.Tensor, ab, n_pad: int, c_pad: int,
              slope: float, flash: bool, grad_work: dict | None = None) -> torch.Tensor:
    """The fused attention's out (n_pad, hf), f32, on an AttnBell;
    differentiable in x, vl and vr when `flash`; its gradient counts
    `grad_work` under `gala.attention.grad`."""
    out, *_ = attn_fwd_op(x, vl, vr, *layout_args(ab.fwd), *layout_args(ab.t), slope, n_pad,
                          c_pad, flash)
    _attach_work(out, grad_work)
    return out
