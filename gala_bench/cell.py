"""One run of one cell: set-up, the measured window, the traced job, the
comparison with the plain reference, and the result line.

The window drives the port's own public path as a GALA user runs it:
`gala_tpu_torch.compile_source(<DSL>, mode="train", data=<graph>)` in
set-up, then back-to-back training jobs, each `CompiledModel.train` of the
DSL's `m1.train(iters, validation_step)` from the seed's weights.  The
window closes at the end of the first job that finishes after `seconds`.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name BENCHMARK.json gives:
configs/<config>.json and its plain reference configs/<config>.py,
traffic/<traffic>.json, metrics/<metric>.py (`read(run)` returns the
number, or None where the cell has nothing to read), and the limits of
the comparison in checks/<cell>.json.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

import torch

from gala_bench import check, graphgen, reference, trace, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STEPS = 3            # the first steps the reference follows
BENCH_TIMING_REPS = 20
BANNED = ("jax", "jaxlib", "flax", "gala_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    model: object          # the configuration's plain reference module
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells it lists, or without a
    list in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def find_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell's files, by the names BENCHMARK.json gives."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_path = os.path.join(ROOT, cfg_entry["file"])
    config = load_json(cfg_path)
    model = load_module(cfg_path[: -len(".json")] + ".py", f"gala_bench_ref_{w['config']}")
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "checks", f"{workload}.json"))["limits"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, config, traffic, model, limits, e2e, per_layer)


@dataclasses.dataclass
class Run:
    """What one run gathers; the per-layer readers read it."""

    cell: Cell
    seed: int
    device: torch.device
    n: int = 0
    nnz: int = 0
    nnz_sub: list = dataclasses.field(default_factory=list)
    feats: int = 0
    classes: int = 0
    cm: object = None
    lower_s: float = 0.0
    setup_s: float = 0.0
    window_s: float = 0.0
    jobs: int = 0
    train_phase_s: list = dataclasses.field(default_factory=list)
    infer_phase_s: list = dataclasses.field(default_factory=list)
    trace: trace.TraceSummary | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def iters(self) -> int:
        return int(self.config["iters"])

    def job_flops(self) -> float:
        c = self.config
        return work.model_flops_per_job(c["model"], self.n, self.feats, int(c["hidden"]),
                                        self.classes, self.nnz, self.nnz_sub, self.iters,
                                        int(c["valid_step"]))

    def time_calls(self, fn) -> float | None:
        """Seconds per call of fn() on the card, by CUDA events over
        BENCH_TIMING_REPS calls after three warm ones; None off the card."""
        if self.device.type != "cuda":
            return None
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BENCH_TIMING_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3 / BENCH_TIMING_REPS


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepWatch:
    """Reads the program's optimizer through torch's global step hooks
    while open: each leaf's gradient as Adam took it in step 1 (its first
    moment over 1 - beta1) and the leaves after the last watched step."""

    def __init__(self, params: torch.nn.Module, steps: int):
        self.names = {id(p): k for k, p in params.named_parameters()}
        self.steps, self.seen = steps, 0
        self.grads, self.params = {}, {}

    def _post(self, opt, args, kwargs):
        self.seen += 1
        ps = [p for group in opt.param_groups for p in group["params"]]
        if self.seen == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            self.grads = {self.names[id(p)]: opt.state[p]["exp_avg"].detach() / (1 - beta1)
                          for p in ps if id(p) in self.names and "exp_avg" in opt.state[p]}
        if self.seen == self.steps:
            self.params = {self.names[id(p)]: p.detach().clone() for p in ps
                           if id(p) in self.names}

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.handle = register_optimizer_step_post_hook(self._post)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def program_params(cm, weights: dict) -> torch.nn.Module:
    """The program's parameter tree holding the harness's weights; the
    names and shapes must be the reference's."""
    params = cm.make_params(0)
    ours = reference.leaves(weights)
    theirs = dict(params.named_parameters())
    if set(ours) != set(theirs) or any(ours[k].shape != theirs[k].shape for k in ours):
        raise ValueError("the compiled program's parameters "
                         f"{sorted((k, tuple(v.shape)) for k, v in theirs.items())} are not "
                         f"the configuration's {sorted((k, tuple(v.shape)) for k, v in ours.items())}")
    with torch.no_grad():
        for k, p in theirs.items():
            p.copy_(ours[k])
    return params


def _check_loop(cm, config: dict) -> None:
    loop = cm.program.loop
    got = {"iters": loop.iters, "valid_step": loop.valid_step, "lr": loop.lr,
           "weight_decay": loop.weight_decay}
    want = {k: config[k] for k in got}
    if any(abs(float(got[k]) - float(want[k])) > 1e-12 for k in got):
        raise ValueError(f"the compiled training loop {got} is not the configuration's {want}")


def build(cell: Cell, run: Run):
    """Set-up up to the compiled program: the graph made on the device,
    its host copy for compile_source and for the reference, and the
    compile.  Returns (compiled model, host graph)."""
    import gala_tpu_torch

    device = run.device
    g = graphgen.make_graph(cell.traffic, device)
    run.n, run.nnz, run.feats = g.n, g.nnz, g.feats.shape[1]
    run.classes = g.n_classes
    masks = reference.layer_rows(g.row, g.col, g.masks["train"], cell.model.LAYERS)
    run.nnz_sub = [int(m[g.row].sum()) for m in masks]
    del masks
    data = graphgen.host_data(g)
    host = graphgen.BenchGraph(n=g.n, crow=g.crow.cpu(), col=g.col.cpu(), row=g.row.cpu(),
                               feats=g.feats.cpu(), labels=g.labels.cpu(),
                               masks={k: v.cpu() for k, v in g.masks.items()})
    del g
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(cell.config["dsl"], mode="train", data=data,
                                       device=device)
    run.lower_s = time.perf_counter() - t0
    _check_loop(cm, cell.config)
    return cm, host


def seed_weights(cell: Cell, run: Run, seed: int) -> dict:
    return reference.init_weights(
        cell.model.shapes(run.feats, int(cell.config["hidden"]), run.classes), seed,
        run.device)


def watched_job(cm, params0) -> tuple:
    """One job from a copy of params0, its first STEPS steps watched:
    (TrainResult, StepWatch)."""
    first = copy.deepcopy(params0)
    with StepWatch(first, STEPS) as watch:
        res = cm.train(params=first)
    return res, watch


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run; returns the result object (`correct`, `metrics`, ...)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    run = Run(cell=cell, seed=seed, device=device)

    # ---- set-up: the graph on the device, compile, one warm job ------- #
    cm, host = build(cell, run)
    run.cm = cm
    weights = seed_weights(cell, run, seed)
    params0 = program_params(cm, weights)

    def job():
        return cm.train(params=copy.deepcopy(params0))

    warm, watch = watched_job(cm, params0)
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # ---- the window ----------------------------------------------------- #
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    failed = 0
    while True:
        last = job()
        run.jobs += 1
        failed += not all(map(_finite, last.losses))
        run.train_phase_s.append(last.total_time)
        run.infer_phase_s.append(last.inference_time)
        _sync(device)
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    peak = max(peak, window_peak)

    metrics, extra = {}, {}
    result_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                     "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu",
                     "count": 1, "memory_peak_bytes": int(peak)}
    if not traced:
        values = {
            "epoch_ms": run.window_s * 1e3 / (run.jobs * run.iters),
            "peak_mem_mb": window_peak / 1e6,
            "setup_s": run.setup_s,
        }
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        run.trace = trace.profile_job(
            job, os.path.join(HERE, "_trace", f"{cell.name}.json"))
        for m in cell.per_layer:
            reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                 f"gala_bench_metric_{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace is not None:
            result_device["busy_s"] = run.trace.busy_s
            result_device["window_s"] = run.trace.window_s
            extra["breakdown"] = {"device_ops": run.trace.device_ops,
                                  "idle_gaps": run.trace.idle_gaps}

    # ---- the comparison, after the program's state is freed ------------ #
    prog_losses = [warm.losses[:STEPS], last.losses[:STEPS]]
    prog_grads, prog_params = watch.grads, watch.params
    del cm, params0, warm, last
    run.cm = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(cell, host, weights, prog_losses, prog_grads, prog_params, device)
    correct = check.judge(numbers, cell.limits) and failed == 0

    return {"correct": correct, "attempted": run.jobs, "failed": failed, "metrics": metrics,
            "device": result_device, **extra,
            "check": {k: {"value": numbers.get(k), "limit": cell.limits[k]}
                      for k in cell.limits}}


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def compare(cell: Cell, host: graphgen.BenchGraph, weights: dict, prog_losses: list,
            prog_grads: dict, prog_params: dict, device, ops=None, loss_rows=None) -> dict:
    """The reference's first steps from the same weights, and the gaps."""
    row, col = host.row.to(device), host.col.to(device)
    rg = reference.RefGraph.from_edges(row, col, host.n)
    loop = {k: cell.config[k] for k in ("lr", "weight_decay", "valid_step")}
    ref = reference.follow(cell.model, rg, host.feats.to(device), host.labels.to(device),
                           host.masks["train"].to(device), weights, loop, STEPS, ops=ops,
                           loss_rows=loss_rows)
    start = reference.leaves(weights)
    return check.gaps(prog_losses, prog_grads, prog_params, ref, start, ref.raw_grads, STEPS)


def banned_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name (gala_tpu_torch is not gala_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def summary_lines(result: dict) -> list[str]:
    return [f"check {k}: {v['value']} limit {v['limit']}" for k, v in result["check"].items()] + [
        f"correct: {result['correct']}"]

