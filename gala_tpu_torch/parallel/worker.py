"""Rank workers for checking the sharded path: what each rank of a spawned
process group runs (multihost.spawn(run_jobs, world, backend, jobs,
out_dir)), each job writing this rank's results to `out_dir` for the
launching process to compare.  It imports neither JAX nor the JAX
package, so a spawned rank of a test that does (tests/
test_torch_parallel.py, against gala_tpu) never loads it; chip_smoke.py
runs the same jobs on the card against the single-device port.

A job is a dict with "kind" (a key of JOBS), "name" and "mesh": every
rank builds the mesh, which every rank must call (parallel.mesh.make_mesh
on (n, model_axis), or parallel.pp.make_pipe_mesh on (n_stages,) for the
pipeline's jobs); ranks outside it skip the job.  Results are pickled,
one file per job and rank, `<name>.<rank>.pkl` (read_results).
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from gala_tpu_torch.parallel.graph import ShardedGraph
from gala_tpu_torch.parallel.mesh import make_mesh
from gala_tpu_torch.parallel.pp import make_pipe_mesh
from gala_tpu_torch.utils.timing import fence


# --------------------------------------------------------------------------- #
# files
# --------------------------------------------------------------------------- #
def dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load(path: str):
    """A pickle that this module or its launcher wrote (never outside data)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def read_results(out_dir: str, name: str) -> dict:
    """{rank: result} of one job."""
    suffix = ".pkl"
    out = {}
    for f in os.listdir(out_dir):
        if f.startswith(name + ".") and f.endswith(suffix):
            rank = f[len(name) + 1 : -len(suffix)]
            if rank.isdigit():
                out[int(rank)] = load(os.path.join(out_dir, f))
    return dict(sorted(out.items()))


def numpy_tree(tree):
    """Tensors of a nested dict/list -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy() if tree.is_floating_point() else \
            tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return tree


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
def make_data(spec, cache: dict | None = None):
    """("synthetic", kwargs) -> data.synthetic.synthetic_dataset(**kwargs);
    ("dataset", name, scale) -> data.datasets.load_dataset.  `cache`
    (run_jobs': one per rank) keeps each spec's data for the next job."""
    key = repr(spec)
    if cache is not None and key in cache:
        return cache[key]
    if spec[0] == "synthetic":
        from gala_tpu_torch.data.synthetic import synthetic_dataset

        data = synthetic_dataset(**spec[1])
    else:
        from gala_tpu_torch.data.datasets import load_dataset

        data = load_dataset(spec[1], None, spec[2])
    if cache is not None:
        cache[key] = data
    return data


def edge_ids(g, sg: ShardedGraph) -> np.ndarray:
    """(S, Es) the host CSR edge id of every shard edge slot, -1 on
    padding: the order ShardedGraph.from_host places them in."""
    r, el = sg.rows_per_shard, sg.edges_local
    shard_of, is_local = g.dst // r, (g.src // r) == (g.dst // r)
    out = np.full((sg.n_shards, sg.edges_per_shard), -1, np.int64)
    for s in range(sg.n_shards):
        loc = np.nonzero((shard_of == s) & is_local)[0]
        rem = np.nonzero((shard_of == s) & ~is_local)[0]
        out[s, : loc.size] = loc
        out[s, el : el + rem.size] = rem
    return out


def op_inputs(n: int, n_edges: int, f: int, heads: int, seed: int) -> dict:
    """The global inputs and cotangents of the "ops" job, from `seed`."""
    rng = np.random.default_rng(seed)
    a = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"x": a(n, f), "vl": a(n, heads), "vr": a(n, heads), "evals": a(n_edges),
            "cot": a(n, f), "cot_edge": a(n_edges)}


# --------------------------------------------------------------------------- #
# jobs
# --------------------------------------------------------------------------- #
def _op_cases(ops, g, grp, slope):
    """{layout: {op: (fn, input names, cotangent name)}} of the ops job."""
    r = g.rows_per_shard

    def halo(e, a):
        return ops.spmd_spmm_halo(g.src_halo, g.dst_local, e, a, g.send_idx, r, g.n_shards,
                                  g.halo, g.edges_local, grp)

    def edge_pair(fn):
        return lambda a, b: fn(g.src, g.dst_local, a[:, :1], b[:, :1], r, grp)

    attention = (lambda a, b, c: ops.spmd_attention(g, a, b, c, slope), ("x", "vl", "vr"), "cot")
    return {
        "gather": {
            "spmm": (lambda a: ops.spmd_spmm(g.src, g.dst_local, g.vals, a, r, grp), ("x",),
                     "cot"),
            "spmm_ev": (lambda e, a: ops.spmd_spmm_ev(g.src, g.dst_local, e, a, r, grp),
                        ("evals", "x"), "cot"),
            "sddvv_add": (edge_pair(ops.spmd_sddvv_add), ("vl", "vr"), "cot_edge"),
            "sddvv_mul": (edge_pair(ops.spmd_sddvv_mul), ("vl", "vr"), "cot_edge"),
            "edge_softmax": (lambda a: ops.spmd_edge_softmax(g.dst_local, a, g.occ, r),
                             ("evals",), "cot_edge"),
            "attention": attention},
        "halo": {"spmm": (lambda a: halo(g.vals, a), ("x",), "cot"),
                 "spmm_ev": (halo, ("evals", "x"), "cot"), "attention": attention},
        "bell": {"spmm": (lambda a: ops.spmd_spmm_bell(g, a), ("x",), "cot"),
                 "spmm_ev": (lambda e, a: ops.spmd_spmm_ev_bell(g, e, a), ("evals", "x"), "cot"),
                 "attention": attention},
    }


OP_LAYOUTS = {"gather": {}, "halo": {"use_halo": True},
              "bell": {"use_bell": True, "attention": True, "edge_vals": True}}
EDGE_INPUTS = ("evals", "cot_edge")


def _op_job(job, mesh, cache) -> dict:
    """Each parallel.ops function on this rank's share of op_inputs (node
    rows, or its shard edges in ShardedGraph order): its output and the
    gradients of <output, cotangent> to every input, on the all_gather,
    halo and bell layouts of one graph.  {"<layout>/<op>": {"out",
    "grads"}}."""
    from gala_tpu_torch.parallel import ops

    g_host = make_data(job["data"], cache)[0]
    s, dev, grp = mesh.coords[0], mesh.device, mesh.data_group
    inp = op_inputs(g_host.n_rows, g_host.n_edges, job["f"], job["heads"], job["seed"])
    out = {}
    for lay, kw in OP_LAYOUTS.items():
        sg = ShardedGraph.from_host(g_host, mesh.shape["data"], **kw)
        g = sg.local(s, dev, grp)
        eid = edge_ids(g_host, sg)[s]

        def share(name):
            a = inp[name]
            if name in EDGE_INPUTS:
                a = np.where(eid >= 0, a[np.maximum(eid, 0)], 0).astype(np.float32)
            else:
                a = sg.rows_of(a, s)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        for op, (fn, names, cot) in _op_cases(ops, g, grp, job["slope"])[lay].items():
            args = [share(n).requires_grad_() for n in names]
            res = fn(*args)
            (res * share(cot)[..., : res.shape[-1]]).sum().backward()
            out[f"{lay}/{op}"] = {"out": numpy_tree(res),
                                  "grads": [numpy_tree(a.grad) for a in args]}
    return out


def _compiled_job(job, mesh, cache) -> dict:
    """A DSL program compiled on this rank and resharded (shard_compiled):
    its invariant prefix and logits under the job's weights, the gradients
    of sum(logits[real rows]^2), and `iters` training epochs from the same
    weights with the kernels' launch counts of that run.  "passes":
    attributes of the spec's passes to set before lowering (e.g.
    attention_fusion False, the unfused GAT)."""
    import gala_tpu_torch
    from gala_tpu_torch.dsl.parser import parse_source
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts
    from gala_tpu_torch.parallel.compiled import shard_compiled
    from gala_tpu_torch.parallel.tp import reduce_from
    from gala_tpu_torch.train import all_reduce_grads
    from gala_tpu_torch.weights import shard_params

    t0 = time.perf_counter()
    spec = parse_source(job["source"])
    for name, value in job.get("passes", {}).items():
        setattr(spec.passes, name, value)
    cm = gala_tpu_torch.compile_model(spec, mode="train", data=make_data(job["data"], cache),
                                      strategy=job.get("strategy", "auto"), device=mesh.device)
    sm = shard_compiled(cm, mesh, **job.get("shard", {}))
    compile_s = time.perf_counter() - t0
    g = sm.full_graphs[0]
    d, r = mesh.coords[0], g.rows_per_shard
    real = max(min(g.n_nodes - d * r, r), 0)
    params_np = load(job["weights"])
    out = {"coords": mesh.coords, "shape": mesh.shape, "plan": sm.plan, "compile_s": compile_s,
           "rows_per_shard": r, "n_nodes": g.n_nodes, "halo": g.halo, "n_shards": g.n_shards,
           "device": str(mesh.device), "backend": mesh.backend,
           "layouts": {"bell": g.bell is not None, "attn": g.attn is not None,
                       "ev": g.ev is not None, "use_halo": g.use_halo}}

    params = shard_params(params_np, sm.plan, mesh)
    with torch.no_grad():
        carry = sm.invariant(sm.full_graphs, sm.x)
    out["carry"] = [numpy_tree(v) for _, v in sorted(carry.items()) if isinstance(v, torch.Tensor)]
    logits = sm.forward(params, sm.full_graphs, carry)
    out["logits"] = numpy_tree(logits)
    if job.get("grads", True):
        loss = reduce_from((logits[:real].float() ** 2).sum(), mesh.data_group)
        loss.backward()
        all_reduce_grads(params, mesh.data_group)
        out["grads"] = {k: numpy_tree(v.grad) if isinstance(v, torch.Tensor) else
                        {kk: numpy_tree(vv.grad) for kk, vv in v.items()}
                        for k, v in params.items()}
    if job.get("iters"):
        params = shard_params(params_np, sm.plan, mesh)
        reset_counts()
        t0 = time.perf_counter()
        res = sm.train(iters=job["iters"], params=params, warmup=job.get("warmup", 5))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out["train_s"] = time.perf_counter() - t0
        out["launches"] = {c.name: c.launches for c in all_counts().values() if c.launches}
        out["on_cuda"] = {c.name: c.reference_calls_on_cuda for c in all_counts().values()
                          if c.reference_calls_on_cuda}
        out.update(losses=res.losses, accuracies=res.accuracies, max_accuracy=res.max_accuracy,
                   total_time=res.total_time, inference_time=res.inference_time)
    return out


def _train_step_job(job, mesh, cache) -> dict:
    """make_sharded_train_step's hand GCN: `steps` steps from the job's
    weights; the losses, then the logits and this rank's parameters."""
    from gala_tpu_torch.parallel.train import make_sharded_train_step

    g_host, feats, labels, masks = make_data(job["data"], cache)
    sg = ShardedGraph.from_host(g_host, mesh.shape["data"], use_halo=job["halo"])
    s, dev = mesh.coords[0], mesh.device
    params, opt, step_fn, fwd_fn = make_sharded_train_step(
        mesh, sg, feats.shape[1], job["hidden"], int(labels.max()) + 1, halo=job["halo"],
        params=load(job["weights"]))

    def rows(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(sg.rows_of(np.asarray(a, dtype), s))).to(dev)

    x, y, mask = rows(feats, np.float32), rows(labels, np.int64), rows(masks["train"], bool)
    losses = []
    for _ in range(job["steps"]):
        params, opt, loss = step_fn(params, opt, x, y, mask)
        losses.append(float(loss))
    with torch.no_grad():
        logits = fwd_fn(params, x)
    return {"coords": mesh.coords, "losses": losses, "logits": numpy_tree(logits),
            "params": numpy_tree({k: dict(v.items()) for k, v in params.items()})}


def assemble(ranks: dict, key: str) -> dict:
    """The full-size parameter tree `key` (e.g. "grads") of a compiled
    job from every rank's TP slices (parallel.tp.rank_slice's inverse,
    over data row 0)."""
    first = next(iter(ranks.values()))
    plan, n_model = first["plan"] or {}, first["shape"]["model"]
    by_m = {x["coords"][1]: x[key] for x in ranks.values() if x["coords"][0] == 0}
    out = {}
    for name, v in first[key].items():
        if name not in plan:
            out[name] = v
            continue
        out[name] = {k: a if plan[name] == "row" and k == "b" else np.concatenate(
            [by_m[m][name][k] for m in range(n_model)],
            axis=1 if (plan[name] == "col" and k == "w") else 0) for k, a in v.items()}
    return out


# --------------------------------------------------------------------------- #
# pipeline jobs (parallel.pp)
# --------------------------------------------------------------------------- #
def gpipe_inputs(n_stages: int, b: int, w: int, n_micro: int, seed: int):
    """The pp_gpipe job's stage matrices ((w, w) each, N(0, 0.3^2)) and
    (n_micro, b, w) microbatch stream, from `seed` (tests/test_pp.py's
    recipe)."""
    rng = np.random.default_rng(seed)
    mats = [rng.normal(size=(w, w)).astype(np.float32) * 0.3 for _ in range(n_stages)]
    return mats, rng.normal(size=(n_micro, b, w)).astype(np.float32)


def relu_stage(params, h, stage):
    """The pp_gpipe job's stage body: relu(h @ w)."""
    return torch.relu(h @ params["w"])


def _gpipe_job(job, mesh, cache) -> dict:
    """parallel.pp.gpipe of relu_stage for each of the job's cases {name:
    (n_micro, w_out)} on gpipe_inputs(P, b, w, n_micro, seed): the output,
    this stage's gradient of sum(out^2) and the host ms of each pass."""
    from gala_tpu_torch.models.common import full_precision_matmuls
    from gala_tpu_torch.parallel.pp import gpipe
    from gala_tpu_torch.weights import stage_params_from_jax

    full_precision_matmuls()
    dev = mesh.device
    out = {"stage": mesh.stage, "backend": mesh.backend, "device": str(dev), "cases": {}}
    for name, (n_micro, w_out) in job["cases"].items():
        mats, xs = gpipe_inputs(mesh.n_stages, job["b"], job["w"], n_micro, job["seed"])
        params = stage_params_from_jax({"w": np.stack(mats)}, mesh.stage, dev)
        xs = torch.from_numpy(xs).to(dev)
        fence(dev)
        dist.barrier(group=mesh.group)  # every stage starts the case together
        t0 = time.perf_counter()
        res = gpipe(mesh, relu_stage, params, xs, w_out)
        fence(dev)
        t1 = time.perf_counter()
        (res.float() ** 2).sum().backward()
        fence(dev)
        out["cases"][name] = {"out": numpy_tree(res), "grad": numpy_tree(params["w"].grad),
                              "forward_ms": (t1 - t0) * 1e3,
                              "backward_ms": (time.perf_counter() - t1) * 1e3}
    return out


def _unmatched_job(job, mesh, cache) -> dict:
    """A schedule the ranks disagree on: stage s streams 1 + s microbatches
    through gpipe, so the next stage waits for a shift that is never sent
    and the group's timeout must end the wait (multihost.spawn)."""
    from gala_tpu_torch.parallel.pp import gpipe

    xs = torch.zeros((1 + mesh.stage, 2, 2), device=mesh.device)
    gpipe(mesh, relu_stage, {"w": torch.eye(2, device=mesh.device)}, xs, 2)
    return {}


def _lost_peer_job(job, mesh, cache) -> dict:
    """A failure that the other rank reports first: stage 0 waits on a
    receive from stage 1; stage 1 leaves the group (stage 0's receive fails
    with a lost connection and its rank ends), waits job["delay"] seconds
    and raises RuntimeError(job["error"]), the cause that multihost.spawn
    must raise."""
    if mesh.stage == 0:
        dist.recv(torch.zeros(1), src=1)
        return {}
    dist.destroy_process_group()
    time.sleep(job["delay"])
    raise RuntimeError(job["error"])


def _shift_ms(mesh, shape, dtype, n: int = 50):
    """Host ms a shift of (shape, dtype) takes from stage 0 to stage 1 in a
    stream of n, as the forward schedule sends them: stage 1's time from
    its first receive to its last, over n - 1; None on the other stages."""
    from gala_tpu_torch.parallel.pp import _recv, _send, _wait

    fence(mesh.device)
    dist.barrier(group=mesh.group)
    if mesh.stage == 0:
        pending, t = [], torch.zeros(shape, dtype=dtype, device=mesh.device)
        for _ in range(n):
            _send(mesh, 1, t, pending)
        _wait(pending)
        return None
    if mesh.stage != 1:
        return None
    _recv(mesh, 0, shape, dtype)
    fence(mesh.device)
    t0 = time.perf_counter()
    for _ in range(n - 1):
        _recv(mesh, 0, shape, dtype)
    fence(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / (n - 1)


def _copy_params_(params, new) -> None:
    """Copy `new` into `params` by parameter name (the optimizer keeps its
    tensors)."""
    src = dict(new.named_parameters())
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(src[name])


def _sage_pipeline_job(job, mesh, cache) -> dict:
    """parallel.pp.make_sage_pipeline on the job's data: `steps` steps over
    one epoch's microbatches (job["micro"], a pickle of numpy t, n1, n2, y,
    m), from gala_tpu's stacked initial params where job["weights"] names
    them (weights.stage_params_from_jax).  Returns the losses and host ms
    of each step; step 1's merged params (merge_sage_params) and this
    stage's gradients ({"l1.fc.w": ...}); this stage's gather calls during
    the steps (the plain version's on the CPU, the kernel's launches on
    CUDA); the kernel launches and plain calls on CUDA of the steps and
    the validation; the steps' peak memory; the merged params' full-graph
    test accuracy (models.sage.forward); on stage 1 the host ms of one
    shift (_shift_ms); with job["logits"], the full-graph logits of the
    initial params."""
    from gala_tpu_torch.models import sage
    from gala_tpu_torch.ops.graph import Graph
    from gala_tpu_torch.ops.kernels import gather as kg
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts
    from gala_tpu_torch.parallel.pp import make_sage_pipeline, merge_sage_params
    from gala_tpu_torch.train import masked_accuracy
    from gala_tpu_torch.weights import params_to_numpy, stage_params_from_jax

    g_host, feats, labels, masks = make_data(job["data"], cache)
    dev = mesh.device
    t0 = time.perf_counter()
    g = Graph.from_host(g_host, device=dev)  # the full graph, for validation
    xt = g.pad_nodes(np.asarray(feats, np.float32))
    y_pad = g.pad_nodes(np.asarray(labels, np.int64))
    test = g.pad_nodes(np.asarray(masks["test"], bool))
    params, opt, step = make_sage_pipeline(mesh, xt, job["f1"], job["hidden"],
                                           int(labels.max()) + 1, seed=job["seed"])
    if job.get("weights"):
        _copy_params_(params, stage_params_from_jax(load(job["weights"]), mesh.stage, dev))
    micro = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in load(job["micro"]).items()}
    n_micro, b = micro["t"].shape
    w_act = (1 + job["f1"]) * job["hidden"]
    out = {"stage": mesh.stage, "backend": mesh.backend, "device": str(dev), "n_micro": n_micro,
           "shift_bytes": b * w_act * xt.element_size(), "setup_s": time.perf_counter() - t0,
           "bubble": (mesh.n_stages - 1) / (n_micro + mesh.n_stages - 1)}
    if job.get("logits"):
        with torch.no_grad():
            out["logits0"] = numpy_tree(sage.forward(merge_sage_params(params, mesh), [g, g], xt))

    plain, calls = kg.gather_rows_reference, []

    def counted(x, idx):
        calls.append(1)
        return plain(x, idx)

    losses, times = [], []
    reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kg.gather_rows_reference = counted
    try:
        for i in range(job["steps"]):
            fence(dev)
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, micro)
            fence(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if i == 0:
                out["merged1"] = params_to_numpy(merge_sage_params(params, mesh))
                out["grads1"] = {k: numpy_tree(p.grad) for k, p in params.named_parameters()}
    finally:
        kg.gather_rows_reference = plain
    out["gather_calls"] = kg.counts.launches if dev.type == "cuda" else len(calls)
    if dev.type == "cuda":
        out["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
    with torch.no_grad():
        merged = merge_sage_params(params, mesh)
        out["accuracy"] = float(masked_accuracy(sage.forward(merged, [g, g], xt), y_pad, test))
    fence(dev)
    out["launches"] = {c.name: c.launches for c in all_counts().values() if c.launches}
    out["on_cuda"] = {c.name: c.reference_calls_on_cuda for c in all_counts().values()
                      if c.reference_calls_on_cuda}
    out["shift_ms"] = _shift_ms(mesh, (b, w_act), xt.dtype)
    out.update(losses=losses, step_ms=times, merged=params_to_numpy(merged))
    return out


# kind: (job, mesh builder over job["mesh"])
JOBS = {"ops": (_op_job, make_mesh), "compiled": (_compiled_job, make_mesh),
        "train_step": (_train_step_job, make_mesh), "pp_gpipe": (_gpipe_job, make_pipe_mesh),
        "pp_sage": (_sage_pipeline_job, make_pipe_mesh),
        "pp_unmatched": (_unmatched_job, make_pipe_mesh),
        "lost_peer": (_lost_peer_job, make_pipe_mesh)}


def run_jobs(rank: int, jobs: list, out_dir: str, threads: int = 1) -> None:
    """Run every job in order on this rank (multihost.spawn's fn)."""
    torch.set_num_threads(threads)
    cache = {}
    for job in jobs:
        fn, make = JOBS[job["kind"]]
        mesh = make(*job["mesh"], device=job.get("device"))
        if mesh is None:
            continue
        res = fn(job, mesh, cache)
        dump(res, os.path.join(out_dir, f"{job['name']}.{rank}.pkl"))
