#!/usr/bin/env python
"""Evaluation harness of the PyTorch/CUDA port (gala_tpu_torch): the twin
of scripts/evaluate.py, with its jobs, flags, CSV headers and row schema.

Mirrors scripts/Evaluations/*.py of the reference (Figures-16-17, 18, 19,
20, Tables 5-7): each run appends `dataset,model,<numbers>` rows to
stat_<job>.csv in --outdir (default results_torch/), and one line per job
to devices.csv there: the device the rows were measured on, with the
card's name and power limit as nvidia-smi reports them.

Jobs:
  fig16   inference+training time, 4 models x datasets
  table5  CIR-vs-DIR optimization breakdown {none,cir,dir,all-tiled}
  fig18   scalability: layers {2,3,4,8} x hidden {32..1024}, GCN
  fig19   memory vs time (print_memory mode)
  fig20   input-aware (opt_input) vs hand-tuned schedules
  table6  graph-size scaling (scale fractions of Products)
  table7  sampling modes {data, kernel, dynamic, none} + accuracy

Differences from scripts/evaluate.py:
- `--device` (default cuda, the card) replaces `--platform`; without a
  card the harness stops unless `--device cpu` is given.  `--dtype`
  takes torch.bfloat16 / torch.float32.
- table5: gala_tpu runs `dir` under GALA_FORCE_COL_TILE=1 and its `all`
  row under the TPU memory gate, which drops the column tile (all ~= cir
  on a TPU).  The port has no such gate and tiles as written, so this
  harness sets no variable and its last row is labelled `all-tiled`: it
  runs cir's coarsening and dir's column tile together.
- Every run ends by rendering <outdir>/RESULTS.md from the CSVs there
  (`render`): scripts/report.py's sections and tables, under a title and
  notes of the port's own that name the card from devices.csv (report.py
  titles its output for the JAX package's TPU runs).  To render without
  a run: python3 -c "import sys; sys.path[:0] = ['scripts'];
  import evaluate_torch; evaluate_torch.render('results_torch')"

Usage: python scripts/evaluate_torch.py --job fig16 --datasets Arxiv --iters 30
       python scripts/evaluate_torch.py --job fig16 --device cpu --scale 0.02 --iters 6
"""
from __future__ import annotations

import argparse
import csv
import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = ["gcn", "gat", "gin", "sage"]
# the reference's full Figure-16 matrix (Figures-16-17.py:7-12); use
# --datasets / --scale to subset
DATASETS = ["Cora", "Pubmed", "CoraFull", "Reddit", "Arxiv", "Products"]
# RESULTS.md notes of the port's own, where report.py's describe the TPU runs
NOTES = {
    "stat_fig16.csv": (
        "Accuracy column: synthetic stand-in data (planted homophilous\n"
        "communities) unless the row says `data=real`.  `-pallas` rows run\n"
        "strategy `pallas_bell`, which the port runs as `bell`."),
    "stat_table5.csv": (
        "`dir` tiles columns as written (no GALA_FORCE_COL_TILE: the port has\n"
        "no memory gate to drop the tile); the last row, `all-tiled`, runs\n"
        "cir's coarsening and dir's column tile together."),
}

GCN_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    deg = G.graphs.degrees();
    norm = dsl.fn.pow(deg, -0.5);
    res = norm * G.node.feats;
    res = aggregate_fn(G.graphs, res);
    res = dsl.nn.ffn(res, out=hs);
    res = norm * res;
    G.node.feats = nonln_fn(res);
}
"""
GAT_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
edgeFn = dsl.get_edge_aggregate(fn = dsl.fn.sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn, edge_fn) {
    res = dsl.nn.ffn(G.node.feats, out=hs);
    attnL = dsl.nn.ffn(res, out=1);
    attnR = dsl.nn.ffn(res, out=1);
    attn = edge_fn(G, attnL, attnR);
    G.edges.vals = dsl.fn.softmax(G, attn);
    res = aggregate_fn(G.graphs, res);
    G.node.feats = nonln_fn(res);
}
"""
GIN_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_sum);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    res_n = aggregate_fn(G.graphs, G.node.feats);
    res = dsl.nn.scalar(1) * G.node.feats;
    res = res + res_n;
    res = dsl.nn.ffn(res, out=hs);
    G.node.feats = nonln_fn(res);
}
"""
SAGE_BODY = """
aggrFn = dsl.get_aggregate(fn = dsl.fn.mul_mean);
L1 = layer(G, hs, nonln_fn, aggregate_fn) {
    res_n = aggregate_fn(G.graphs, G.node.feats);
    res = dsl.nn.ffn(res_n, out=hs) + dsl.nn.ffn(res, out=hs);
    G.node.feats = nonln_fn(res);
}
"""
BODIES = {"gcn": GCN_BODY, "gat": GAT_BODY, "gin": GIN_BODY, "sage": SAGE_BODY}


def make_dsl(model: str, dataset: str, layers=2, hidden=32, iters=100,
             schedule: str = "", heads: int = 1) -> str:
    body = BODIES[model]
    if model == "gat" and heads > 1:
        # multi-head GAT: heads share one fused slot gather, per-head
        # softmax/reduce
        schedule = f"attention_heads({heads});\n" + schedule
    inits = []
    for i in range(layers):
        size = str(hidden) if i < layers - 1 else "G.labels.size()"
        nonln = "non_ln" if i < layers - 1 else "null"
        extra = ", edgeFn" if model == "gat" else ""
        inits.append(f"\tl{i+1} = L1(G, {size}, {nonln}, aggrFn{extra});")
    return (
        f'G = load_dataset("{dataset}");\n{body}\n'
        "M1 = model(G, non_ln) {\n" + "\n".join(inits) + "\n}\n"
        "m1 = M1(G, dsl.non_ln.ReLU);\n"
        f"m1.train(iters={iters}, validation_step=5);\n"
        "res = m1.eval();\n# schedule\n" + schedule
    )


def run_one(src: str, mode="train", iters=30, data=None, scale=1.0, device="cuda",
            **low_kw):
    import gala_tpu_torch

    cm = gala_tpu_torch.compile_source(src, mode=mode, data=data, scale=scale,
                                       device=device, **low_kw)
    res = cm.train(iters=iters)
    return cm, res


def data_kind(args, dataset: str) -> str:
    """Provenance marker written into every accuracy-bearing CSV row, so
    a synthetic stand-in accuracy is never silently diffed against the
    reference's real-dataset numbers.  'real' only when --data-root points
    at an exported GALA npy dir for this dataset (scripts/export_npy.py
    layout)."""
    if args.data_root:
        from gala_tpu_torch.data.datasets import canonical_name

        p = os.path.join(args.data_root, canonical_name(dataset), "Adj_src.npy")
        if os.path.exists(p):
            return "real"
    return "synthetic"


def append_csv(path: str, header: str, row: str):
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(header + "\n")
        f.write(row + "\n")
    print(row)


def device_line(device: str) -> str:
    """'<name>, <power limit>' of the card as nvidia-smi reports them, or
    the torch device's name off the card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return smi.splitlines()[index]


def record_device(args):
    import torch

    line = device_line(args.device)
    append_csv(os.path.join(args.outdir, "devices.csv"),
               "job,datasets,scale,iters,strategy,tag,device,torch,cuda",
               f"{args.job},{' '.join(args.datasets)},{args.scale},{args.iters},"
               f"{args.strategy},{args.tag},"
               f"\"{line}\",{torch.__version__},{torch.version.cuda}")


def devices(outdir: str) -> list[str]:
    """The distinct devices of <outdir>/devices.csv (the card's name and
    power limit, with torch and CUDA), in the order they first appear."""
    path = os.path.join(outdir, "devices.csv")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = list(csv.DictReader(f))
    seen = {}
    for r in rows:
        seen.setdefault(f"{r['device']} (torch {r['torch']}, CUDA {r['cuda']})", None)
    return list(seen)


def render(outdir: str) -> str:
    """Write <outdir>/RESULTS.md from the stat CSVs there, with
    scripts/report.py's sections and table format (newest row per config
    wins) under a title naming the card of devices.csv.  Returns the
    path."""
    spec = importlib.util.spec_from_file_location(
        "report", os.path.join(os.path.dirname(os.path.abspath(__file__)), "report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    cards = devices(outdir)
    title = cards[0].split(" (torch")[0] if len(cards) == 1 else (
        "; ".join(c.split(" (torch")[0] for c in cards) if cards else "device not recorded")
    parts = [
        f"# Results — gala_tpu_torch on {title}, host-timed per-epoch means\n",
        f"GENERATED by `scripts/evaluate_torch.py` from `{outdir}/` (newest row per config "
        "wins). Do not hand-edit.\n",
        "Produced by `scripts/evaluate_torch.py` jobs, the PyTorch/CUDA port's\n"
        "twin of `scripts/evaluate.py`, on the device(s) that `devices.csv`\n"
        "records: " + ("; ".join(cards) if cards else "none recorded") + ".\n"
        "Datasets are registry-shaped synthetic stand-ins unless a `--data-root`\n"
        "with real npy exports was given.  Schema and protocol match the\n"
        "reference's evaluation harness (scripts/Evaluations/*.py): the first\n"
        "5 epochs are left out, times are mean seconds per epoch, each phase\n"
        "timed on the host between two device synchronizes.  f32 activations\n"
        "unless noted.\n",
    ]
    for name, heading, fmt in report.SECTIONS:
        header, rows = report.merged([outdir], name)
        if header is None:
            continue
        parts.append(f"\n## {heading}\n")
        if name in NOTES:
            parts.append(NOTES[name] + "\n")
        parts.append(report.md_table(header, rows, fmt))
    out = os.path.join(outdir, "RESULTS.md")
    with open(out, "w") as f:
        f.write("\n".join(parts))
    return out


def job_fig16(args):
    out = os.path.join(args.outdir, "stat_fig16.csv")
    for dataset in args.datasets:
        for model in args.models:
            src = make_dsl(model, dataset, iters=args.iters,
                           layers=args.layers[0], heads=args.heads)
            cm, res = run_one(src, iters=args.iters, scale=args.scale,
                              device=args.device, strategy=args.strategy,
                              data_root=args.data_root)
            label = model if args.heads <= 1 or model != "gat" else (
                f"{model}-h{args.heads}"
            )
            if args.tag:
                label = f"{label}-{args.tag}"
            append_csv(
                out, "dataset,model,inference_time,total_time,accuracy,data",
                f"{dataset},{label},{res.inference_time},{res.total_time},"
                f"{res.max_accuracy},{data_kind(args, dataset)}",
            )


def job_fig18(args):
    out = os.path.join(args.outdir, "stat_fig18.csv")
    for layers in args.layers:
        for hidden in args.hidden:
            src = make_dsl("gcn", args.datasets[0], layers=layers, hidden=hidden)
            cm, res = run_one(src, iters=args.iters, scale=args.scale, device=args.device)
            append_csv(
                out, "dataset,layers,hidden,inference_time,total_time",
                f"{args.datasets[0]},{layers},{hidden},{res.inference_time},{res.total_time}",
            )


def job_fig19(args):
    """Memory-vs-time schedule tradeoff (reference: Figure-19.py
    exec_types ["memory", "time"]), swept over every dataset in
    --datasets."""
    out = os.path.join(args.outdir, "stat_fig19.csv")
    variants = [
        ("time", ""),
        ("memory", "training_subgraph(false);\ntrain_code_motion(false);\n"),
    ]
    for dataset in args.datasets:
        for label, sched in variants:
            src = make_dsl("gcn", dataset, schedule=sched + "print_memory(true);\n")
            cm, res = run_one(src, iters=args.iters, scale=args.scale, device=args.device)
            append_csv(
                out, "dataset,variant,memory_mb,inference_time,total_time",
                f"{dataset},{label},{res.memory_mb},{res.inference_time},{res.total_time}",
            )


def job_fig20(args):
    out = os.path.join(args.outdir, "stat_fig20.csv")
    for dataset in args.datasets:
        hand = make_dsl("gcn", dataset)
        auto = make_dsl("gcn", dataset, schedule=f'G=G.opt_input("{dataset}");\n')
        for label, src in [("hand", hand), ("auto", auto)]:
            cm, res = run_one(src, iters=args.iters, scale=args.scale, device=args.device)
            append_csv(
                out, "dataset,schedule,inference_time,total_time",
                f"{dataset},{label},{res.inference_time},{res.total_time}",
            )


# table5's variants: (label, schedule lines, strategy).  'none' = the
# segment baseline with all passes off; 'cir' = the compute transform
# (coarsened kernels -> binned ELL); 'dir' = the data transform (ordered
# column tiling -> segment_scan); 'all-tiled' = both, with
# operator_reordering and sparse_rewrites on.  The port honours the
# column tile as written in 'dir' and 'all-tiled' alike (gala_tpu's 'all'
# row drops it under its TPU memory gate, hence the other label).
_OFF4 = ("operator_reordering(false);\nsparse_rewrites(false);\n"
         "training_subgraph(false);\ntrain_code_motion(false);\n")
_OFF2 = "training_subgraph(false);\ntrain_code_motion(false);\n"
TABLE5 = [
    ("none", _OFF4, "segment"),
    ("cir", "aggrFn=aggrFn.coarsen(2);\n" + _OFF4, "bell"),
    ("dir", "G=G.col_tile(37000);\n" + _OFF4, "segment_scan"),
    ("all-tiled", "aggrFn=aggrFn.coarsen(2);\nG=G.col_tile(37000);\n" + _OFF2, "bell"),
]


def job_table5(args):
    """CIR-vs-DIR optimization breakdown (reference: Table-5.py +
    tests/GALA-DSL/ablations/speedups/cir-vs-dir/); variants in TABLE5."""
    out = os.path.join(args.outdir, "stat_table5.csv")
    for dataset in args.datasets:
        for label, sched, strat in TABLE5:
            src = make_dsl("gcn", dataset, schedule=sched)
            cm, res = run_one(src, mode="inference", iters=args.iters,
                              scale=args.scale, device=args.device, strategy=strat)
            append_csv(
                out, "dataset,opts,inference_time,total_time",
                f"{dataset},{label},{res.inference_time},{res.total_time}",
            )


def job_table6(args):
    """Graph-size scaling via node-sampled fractions (reference:
    Table-6.py runs papers100M_P{1,2,5,10,20})."""
    out = os.path.join(args.outdir, "stat_table6.csv")
    ds = args.t6_dataset
    for frac in args.fractions:
        src = make_dsl("gcn", ds, schedule="print_memory(true);\n")
        cm, res = run_one(src, iters=args.iters, scale=frac * args.scale,
                          device=args.device, dtype=args.torch_dtype)
        append_csv(
            out, "dataset,fraction,inference_time,total_time,memory_mb",
            f"{ds},{frac},{res.inference_time},{res.total_time},{res.memory_mb}",
        )


def job_table7(args):
    out = os.path.join(args.outdir, "stat_table7.csv")
    modes = {
        "none": "",
        "data": "G=G.sample(20);\n",
        "kernel": "aggrFn=aggrFn.sample(20);\n",
        "dynamic": "aggrFn=aggrFn.sample(20).dynamic();\n",
    }
    for label, sched in modes.items():
        src = make_dsl("gcn", args.datasets[0], schedule=sched + "print_accuracy(true);\n")
        cm, res = run_one(src, iters=args.iters, scale=args.scale, device=args.device,
                          data_root=args.data_root)
        append_csv(
            out, "dataset,sampling,inference_time,accuracy,data",
            f"{args.datasets[0]},{label},{res.inference_time},"
            f"{res.max_accuracy},{data_kind(args, args.datasets[0])}",
        )


JOBS = {
    "fig16": job_fig16,
    "table5": job_table5,
    "fig18": job_fig18,
    "fig19": job_fig19,
    "fig20": job_fig20,
    "table6": job_table6,
    "table7": job_table7,
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", choices=sorted(JOBS), required=True)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset scale fraction (synthetic stand-ins)")
    ap.add_argument("--datasets", nargs="+", default=DATASETS)
    ap.add_argument("--models", nargs="+", default=MODELS)
    ap.add_argument("--fractions", nargs="+", type=float,
                    default=[0.01, 0.02, 0.05, 0.1, 0.2])
    ap.add_argument("--layers", nargs="+", type=int, default=[2, 3, 4, 8])
    ap.add_argument("--heads", type=int, default=1,
                    help="GAT attention heads (fig16; hidden % heads == 0)")
    ap.add_argument("--hidden", nargs="+", type=int,
                    default=[32, 64, 128, 256, 512, 1024])
    ap.add_argument("--t6-dataset", default="Products",
                    help="table6 dataset (reference uses papers100M; "
                         "pass Papers100M for fraction-sampled runs)")
    ap.add_argument("--dtype", default=None, choices=[None, "bf16", "f32"],
                    help="activation dtype (torch.bfloat16 / torch.float32)")
    ap.add_argument("--strategy", default="auto",
                    help="fig16 execution strategy (e.g. pallas_bell, which the "
                         "port runs as bell)")
    ap.add_argument("--tag", default="",
                    help="suffix appended to the fig16 model label so "
                         "strategy-variant rows stay distinguishable")
    ap.add_argument("--data-root", default=None, dest="data_root",
                    help="directory of real exported datasets "
                         "(scripts/export_npy.py layout: <root>/<Name>/"
                         "Adj_src.npy ...); rows carry data=real when "
                         "found, data=synthetic otherwise")
    ap.add_argument("--outdir", default="results_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu for a CPU run)")
    return ap


def main(argv=None):
    import torch

    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("evaluate_torch.py: no CUDA device; pass --device cpu for a CPU run")
    args.torch_dtype = {None: None, "bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    os.makedirs(args.outdir, exist_ok=True)
    record_device(args)
    JOBS[args.job](args)
    render(args.outdir)


if __name__ == "__main__":
    main()
