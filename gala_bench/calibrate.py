"""Readings behind the benchmark's data, made on the card.

    python3 gala_bench/calibrate.py draws --traffic reddit
        the R-MAT draws that land the traffic's nonzeros on its target
        (bisection over whole graphs made on the device);
    python3 gala_bench/calibrate.py readings --workload <cell> \\
            --seeds 1 2 ... --control-seeds 7 8 9
        the comparison's numbers (gala_bench.check) in one process, the
        cell built once: the program from each seed's weights against
        the reference (the lower readings); the control, the reference
        with its dense products in TF32, in the program's place; and the
        faults a training cell can have, planted in the reference put in
        the program's place: half of the train rows left out of the loss
        (its mean over the rest), one node's aggregation doubled where it
        is produced, and a state left unchanged (upper readings).
One JSON object a line on standard output.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from gala_bench import cell as cells  # noqa: E402
from gala_bench import check, graphgen, reference  # noqa: E402


def draws(traffic_name: str, device, write: bool) -> None:
    t = cells.load_json(os.path.join(HERE, "traffic", f"{traffic_name}.json"))
    target = int(t["nonzeros_target"])

    def nnz(d):
        g = graphgen.make_graph(dict(t, draws=int(d)), device, check_nnz=False)
        out = g.nnz
        del g
        torch.cuda.empty_cache()
        print(json.dumps({"draws": int(d), "nonzeros": out, "of_target": out / target}),
              flush=True)
        return out

    pts = [(int(t["draws"]), nnz(int(t["draws"])))]
    for _ in range(8):  # secant steps; the first as if nonzeros ~ draws
        d, got = pts[-1]
        if abs(got - target) <= 0.001 * target:
            break
        if len(pts) == 1:
            d = int(round(d * target / got))
        else:
            (d0, g0), (d1, g1) = pts[-2], pts[-1]
            d = int(round(d1 + (target - g1) * (d1 - d0) / (g1 - g0)))
        pts.append((d, nnz(d)))
    d, got = pts[-1]
    if write:
        t.update(draws=d, nonzeros_reached=got)
        with open(os.path.join(HERE, "traffic", f"{traffic_name}.json"), "w") as f:
            json.dump(t, f, indent=1)


class AlteredOps(reference.Ops):
    """The reference with one node's aggregation doubled where it is
    produced (the node with the most edges)."""

    def __init__(self, node: int):
        super().__init__()
        self.node = node

    def _alter(self, out):
        scale = torch.ones((out.shape[0], 1), dtype=out.dtype, device=out.device)
        scale[self.node] = 2.0
        return out * scale

    def aggregate(self, g, h):
        return self._alter(super().aggregate(g, h))

    def attention(self, g, h, vl, vr, slope):
        return self._alter(super().attention(g, h, vl, vr, slope))


def readings(workload: str, seeds: list, control_seeds: list, device) -> None:
    c = cells.find_cell(workload)
    run = cells.Run(cell=c, seed=seeds[0], device=device)
    t0 = time.perf_counter()
    cm, host = cells.build(c, run)
    print(json.dumps({"built_s": time.perf_counter() - t0, "lower_s": run.lower_s,
                      "nnz": run.nnz, "nnz_sub": run.nnz_sub}), flush=True)
    rg = reference.RefGraph.from_edges(host.row.to(device), host.col.to(device), host.n)
    train = host.masks["train"].to(device)
    feats, labels = host.feats.to(device), host.labels.to(device)
    subs = reference.training_subgraphs(rg, train, c.model.LAYERS)
    loop = {k: c.config[k] for k in ("lr", "weight_decay", "valid_step")}

    def follow(weights, **kw):
        return reference.follow(c.model, rg, feats, labels, train, weights, loop, cells.STEPS,
                                subs=subs, **kw)

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"kind": kind, "seed": seed, **numbers, **extra}), flush=True)

    def by_leaf(grads, params, ref, start):
        """Each leaf's step-1 gradient norm and change norm, beside the
        reference's."""
        out = {}
        for k in sorted(ref.grads):
            out[k] = [float(grads[k].double().norm()), float(ref.grads[k].double().norm()),
                      float((params[k] - start[k]).double().norm()),
                      float((ref.params[k] - start[k]).double().norm()),
                      float(ref.raw_grads[k].double().norm())]
        return out

    for seed in seeds:
        weights = cells.seed_weights(c, run, seed)
        params0 = cells.program_params(cm, weights)
        res, watch = cells.watched_job(cm, params0)
        ref = follow(weights)
        start = reference.leaves(weights)
        numbers = check.gaps([res.losses[: cells.STEPS]], watch.grads, watch.params, ref,
                             start, ref.raw_grads, cells.STEPS)
        emit("program", seed, numbers, max_accuracy=res.max_accuracy,
             losses=res.losses[: cells.STEPS], ref_losses=ref.losses,
             leaves=by_leaf(watch.grads, watch.params, ref, start))

    rows = torch.nonzero(train).flatten()
    hub = int(torch.argmax(rg.degrees()[:, 0]))
    for seed in control_seeds:
        weights = cells.seed_weights(c, run, seed)
        start = reference.leaves(weights)
        ref = follow(weights)
        planted = {
            "control_tf32": follow(weights, ops=reference.Ops(tf32=True)),
            "fault_half_batch": follow(weights, loss_rows=rows[::2]),
            "fault_altered_row": follow(weights, ops=AlteredOps(hub)),
            "fault_unchanged": reference.Readings(ref.losses, ref.grads, dict(start),
                                                  ref.raw_grads),
        }
        for kind, r in planted.items():
            emit(kind, seed, check.gaps([r.losses], r.grads, r.params, ref, start,
                                        ref.raw_grads, cells.STEPS),
                 leaves=by_leaf(r.grads, r.params, ref, start))


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="what", required=True)
    d = sub.add_parser("draws")
    d.add_argument("--traffic", required=True)
    d.add_argument("--write", action="store_true",
                   help="store the draws and the nonzeros reached in the traffic file")
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--control-seeds", type=int, nargs="*", default=[])
    r.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.what == "draws":
        draws(args.traffic, torch.device("cuda"), args.write)
    else:
        readings(args.workload, args.seeds, args.control_seeds, torch.device(args.device))


if __name__ == "__main__":
    main()
