"""The compiler's command line, the reference's five executables as
subcommands (the port of gala_tpu.__main__):

    python -m gala_tpu_torch inference        model.txt [--iters N] [--data-root D]
    python -m gala_tpu_torch inference_sample ...   (adds accuracy to the CSV)
    python -m gala_tpu_torch train            ...   (all passes)
    python -m gala_tpu_torch train_memory     ...   (adds device-memory MB)

Each prints the reference's stdout CSV contract
(`inference_time,total_time[,max_acc]` / `memMB,...`).  The program runs
on the card unless `--device cpu` is given.  Sampling needs no flag: a
program's `G=G.sample(k);`, `aggrFn=aggrFn.sample(k);` or
`aggrFn=aggrFn.sample(k).dynamic();` line selects it.  `inference_long` (int64
edge indices) and `export` / `run_exported` are not ported yet and
raise, naming their ROADMAP items.
"""
from __future__ import annotations

import argparse
import sys
import time

COMMANDS = ("inference", "inference_long", "inference_sample", "train", "train_memory",
            "export", "run_exported")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="gala_tpu_torch")
    ap.add_argument("command", choices=COMMANDS)
    ap.add_argument("model", help="GALA DSL program (.txt)")
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

    from gala_tpu_torch.api import compile_file
    from gala_tpu_torch.ops.graph import not_ported

    if args.command == "inference_long":
        raise not_ported("the inference_long subcommand (int64 edge indices)",
                         "ROADMAP Queue 1 item 9")
    if args.command in ("export", "run_exported"):
        raise not_ported(f"the {args.command} subcommand", "ROADMAP Queue 1 item 11")

    t0 = time.perf_counter()
    mode = "train" if args.command.startswith("train") else "inference"
    dtype = {None: None, "bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    cm = compile_file(
        args.model,
        mode=mode,
        data_root=args.data_root,
        scale=args.scale,
        strategy=args.strategy,
        seed=args.seed,
        dtype=dtype,
        device=args.device,
    )
    # the flags each reference executable bakes in
    if args.command == "inference_sample":
        cm.spec.print_accuracy = True
    if args.command == "train_memory":
        cm.spec.print_memory = True
    print(f"# GALA compile: {time.perf_counter() - t0:.2f}s "
          f"(reference prints 'Time taken for GALA compilation')", file=sys.stderr)
    print(cm.run(iters=args.iters))


if __name__ == "__main__":
    main()
