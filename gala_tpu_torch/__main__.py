"""The compiler's command line, the reference's five executables as
subcommands (the port of gala_tpu.__main__):

    python -m gala_tpu_torch inference        model.txt [--iters N] [--data-root D]
    python -m gala_tpu_torch inference_long   ...   (int64 edge indices)
    python -m gala_tpu_torch inference_sample ...   (adds accuracy to the CSV)
    python -m gala_tpu_torch train            ...   (all passes)
    python -m gala_tpu_torch train_memory     ...   (adds device-memory MB)

Each prints the reference's stdout CSV contract
(`inference_time,total_time[,max_acc]` / `memMB,...`).  The program runs
on the card unless `--device cpu` is given.  Sampling needs no flag: a
program's `G=G.sample(k);`, `aggrFn=aggrFn.sample(k);` or
`aggrFn=aggrFn.sample(k).dynamic();` line selects it, and column tiling
a `G=G.col_tile(T);` line.  `inference_long` is `inference` with int64
edge ids (lower(use_long=True)); torch needs no x64 switch.

    python -m gala_tpu_torch export model.txt [-o DIR] [--platforms cuda cpu]
    python -m gala_tpu_torch run_exported DIR [--iters N]

`export` compiles with the training passes and writes the artifact
(gala_tpu_torch.export; DIR defaults to <model>_exported) for the
`--device`'s type unless `--platforms` names others, and prints DIR;
`run_exported` loads it on `--device`, with no parser, IR or passes,
and prints the CSV line of its replayed training.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

COMMANDS = ("inference", "inference_long", "inference_sample", "train", "train_memory",
            "export", "run_exported")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="gala_tpu_torch")
    ap.add_argument("command", choices=COMMANDS)
    ap.add_argument("model", help="GALA DSL program (.txt); artifact directory for run_exported")
    ap.add_argument("-o", "--out", default=None, help="export: artifact output directory")
    ap.add_argument("--platforms", nargs="+", default=None,
                    help="export: devices the artifact is exported for (default: --device's)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--data-root", default=None, help="GALA npy dataset root")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="synthetic-dataset scale when no data root")
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--dtype", default=None, choices=[None, "bf16", "f32"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    if args.command == "run_exported":
        # replay an artifact: no parser, IR or passes (the analog of
        # re-running the reference's built ./gala_model)
        from gala_tpu_torch.export import load_exported

        print(load_exported(args.model, device=args.device).run(iters=args.iters))
        return

    from gala_tpu_torch.api import compile_file

    t0 = time.perf_counter()
    # export writes the forward the training step runs: the train passes
    mode = "train" if args.command.startswith("train") or args.command == "export" else "inference"
    dtype = {None: None, "bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    cm = compile_file(
        args.model,
        mode=mode,
        data_root=args.data_root,
        scale=args.scale,
        strategy=args.strategy,
        seed=args.seed,
        dtype=dtype,
        use_long=args.command == "inference_long",
        device=args.device,
    )
    # the flags each reference executable bakes in
    if args.command == "inference_sample":
        cm.spec.print_accuracy = True
    if args.command == "train_memory":
        cm.spec.print_memory = True
    print(f"# GALA compile: {time.perf_counter() - t0:.2f}s "
          f"(reference prints 'Time taken for GALA compilation')", file=sys.stderr)
    if args.command == "export":
        from gala_tpu_torch.export import export_compiled

        out = args.out or os.path.splitext(args.model)[0] + "_exported"
        platforms = args.platforms or [torch.device(args.device).type]
        print(export_compiled(cm, out, platforms=tuple(platforms)))
        return
    print(cm.run(iters=args.iters))


if __name__ == "__main__":
    main()
