"""The fused attention kernels' share of their roofline:
ops.attention.attention_aggregate on the full graph at the hidden width,
one head, forward and gradient, timed by CUDA events after the window;
the work from the benchmark's CSR (gala_bench.work)."""
import torch

from gala_bench import work

SLOPE = 0.2


def read(run):
    if run.cm is None or run.config["model"] != "gat" or run.device.type != "cuda":
        return None
    from gala_tpu_torch.ops.attention import attention_aggregate

    g = run.cm.full_graphs[0]
    if g.attn is None:
        return None
    width = int(run.config["hidden"])
    gen = torch.Generator(device=run.device).manual_seed(run.seed)

    def leaf(rows, cols):
        return torch.randn((rows, cols), generator=gen, device=run.device, requires_grad=True)

    x, vl, vr = leaf(g.c_pad, width), leaf(g.c_pad, 1), leaf(g.n_pad, 1)
    dy = torch.randn((g.n_pad, width), generator=gen, device=run.device)

    def call():
        out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, g.attn, x, vl, vr)
        return torch.autograd.grad(out, (x, vl, vr), dy)

    t = run.time_calls(call)
    return work.roofline_pct(work.attention_work(run.n, run.nnz, width), t)
