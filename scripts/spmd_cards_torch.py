#!/usr/bin/env python3
"""The port's sharded path over every card of one host (NCCL, one rank a
card) against the single-device port on one of them.

    python3 scripts/spmd_cards_torch.py [--models gcn,gat] [--epochs 20]
    python3 scripts/spmd_cards_torch.py --pp

For each model (__graft_entry__.GCN_DSL, GAT_DSL) on the Arxiv stand-in
(scale 1.0): the single-device port on cuda:0 trains `epochs` epochs
(warmup 2; train and inference seconds per epoch, max test accuracy),
and its logits, invariant prefix and gradients of sum(logits^2) under
make_params(0) are the reference; then shard_compiled(use_bell=True)
over torch.cuda.device_count() NCCL ranks (parallel.worker's compiled
job, spawned by parallel.multihost.spawn) from the same weights: the
same checks as chip_smoke.py's [spmd] phase (within 1e-4 of the
largest), each rank's train and inference seconds per epoch, accuracy
and kernel launches, and the halo's rows and bytes an exchange.  Ends
with the card's name and power limit and one JSON line.  Needs at
least one NVIDIA GPU; with one, the mesh is one rank.  Imports nothing
of JAX.

--pp runs the pipeline instead (parallel.pp.make_sage_pipeline): 2
NCCL ranks, a card each (needs two cards), train_sage_minibatch's
defaults on one epoch's microbatches a step, 20 steps, against the
sequential single-device run on cuda:0 (chip_smoke.py's [pp-sage]
checks: step 1's loss and params, accuracy, the gather launches); each
stage's ms a step, bubble, bytes a shift and peak memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default="gcn,gat")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--pp", action="store_true", help="the SAGE pipeline over 2 NCCL ranks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import chip_smoke as cs
    from gala_tpu_torch.data.datasets import load_dataset
    from gala_tpu_torch.ops.kernels import attn_bell, bell_spmm, gather, sddmm
    from gala_tpu_torch.parallel import multihost, worker

    n_cards = torch.cuda.device_count()
    print(f"{cs.nvidia_smi()}; {n_cards} card(s); torch {torch.__version__}", flush=True)
    # every library built here, before the ranks start
    with ThreadPoolExecutor(max_workers=4) as pool:
        [f.result() for f in [pool.submit(m.build) for m in
                              (bell_spmm, attn_bell, sddmm, gather)]]
    arxiv = load_dataset("Arxiv", None, 1.0)
    if args.pp:
        return pipeline(cs, arxiv, n_cards)
    programs = {"gcn": ("GCN_DSL", ("bell_spmm",)), "gat": ("GAT_DSL", ("attn_fwd", "attn_bwd2"))}
    out = {"device": torch.cuda.get_device_name(0), "cards": n_cards, "models": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for model in args.models.split(","):
            dsl, kernels = programs[model]
            source = cs._spmd_source(dsl, "")
            import gala_tpu_torch

            cm = gala_tpu_torch.compile_source(source, mode="train", data=arxiv, device="cuda")
            res = cm.train(iters=args.epochs, warmup=2)
            del cm
            single = {"train_ms": res.total_time * 1e3, "inference_ms": res.inference_time * 1e3,
                      "max_accuracy": res.max_accuracy}
            print(f"[{model}] one card: train {single['train_ms']:.4f} ms/epoch, inference "
                  f"{single['inference_ms']:.4f}, max accuracy {single['max_accuracy']:.4f}",
                  flush=True)
            ref = cs._spmd_reference(model, source, {}, arxiv)
            weights = os.path.join(tmp, f"{model}.weights.pkl")
            worker.dump(ref["params"], weights)
            job = dict(kind="compiled", name=f"cards-{model}", mesh=(n_cards, 1), device=None,
                       source=source, data=("dataset", "Arxiv", 1.0), weights=weights,
                       shard={"use_bell": True}, iters=args.epochs, warmup=2)
            t0 = time.perf_counter()
            multihost.spawn(worker.run_jobs, n_cards, "nccl", [job], tmp, 2)
            print(f"[{model}] {n_cards} NCCL rank(s) in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            ranks = worker.read_results(tmp, job["name"])
            launches = cs._check_spmd(f"cards-{model}", ranks, ref, n_cards, None, kernels,
                                      args.epochs)
            first = ranks[0]
            out["models"][model] = {
                "single": single, "halo_rows": first["halo"], "shards": first["n_shards"],
                "ranks": {r: {"train_ms": x["total_time"] * 1e3,
                              "inference_ms": x["inference_time"] * 1e3,
                              "max_accuracy": x["max_accuracy"], "launches": launches[r]}
                          for r, x in ranks.items()}}
    print(cs.nvidia_smi())
    print(json.dumps(out))
    return 0


def pipeline(cs, arxiv, n_cards) -> int:
    """The SAGE pipeline over NCCL ranks 0-1, a card each, against the
    sequential single-device run."""
    from gala_tpu_torch.parallel import multihost, worker

    if n_cards < 2:
        raise SystemExit(f"--pp needs two cards, this host has {n_cards}")
    with tempfile.TemporaryDirectory() as tmp:
        _, _, cards, refs = cs.pp_jobs(arxiv, tmp)
        t0 = time.perf_counter()
        multihost.spawn(worker.run_jobs, 2, "nccl", cards, tmp, 2, timeout=cs.SPAWN_TIMEOUT)
        print(f"[pp] 2 NCCL ranks in {time.perf_counter() - t0:.1f} s", flush=True)
        ranks = worker.read_results(tmp, cards[0]["name"])
        launches = cs._check_sage("pp-nccl-cards", ranks, refs["sage"])
    ref = refs["sage"]
    out = {"device": torch.cuda.get_device_name(0), "cards": n_cards,
           "sequential": {"step_ms": ref["step_ms"], "losses": ref["losses"],
                          "accuracy": ref["accuracy"]},
           "stages": {r: {"step_ms": x["step_ms"], "peak_mb": x["peak_mb"],
                          "accuracy": x["accuracy"], "losses": x["losses"],
                          "launches": launches[r]} for r, x in ranks.items()},
           "bubble": ranks[0]["bubble"], "shift_bytes": ranks[0]["shift_bytes"],
           "n_micro": ranks[0]["n_micro"]}
    print(cs.nvidia_smi())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
