"""The SpMM kernel's share of its roofline: ops.spmm.spmm on the full
graph at the hidden width, forward and gradient, timed by CUDA events
after the window; the work from the benchmark's CSR (gala_bench.work)."""
import torch

from gala_bench import work


def read(run):
    if run.cm is None or run.config["model"] != "gcn" or run.device.type != "cuda":
        return None
    from gala_tpu_torch.ops.spmm import spmm

    g = run.cm.full_graphs[0]
    if g.strategy != "bell":
        return None
    width = int(run.config["hidden"])
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    x = torch.randn((g.c_pad, width), generator=gen, device=run.device, requires_grad=True)
    dy = torch.randn((g.n_pad, width), generator=gen, device=run.device)
    t = run.time_calls(lambda: torch.autograd.grad(spmm(g, x), x, dy))
    return work.roofline_pct(work.spmm_work(run.n, run.nnz, width), t)
