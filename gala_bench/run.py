"""Run one cell of the benchmark once and print its result line.

    python3 gala_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are BENCHMARK.json's.  Needs a
CUDA device: without one it exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")


def _fixed_caches() -> None:
    """Kernel and extension caches at fixed paths inside the checkout, so
    only the first run of a checkout builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["GALA_DATASET_CACHE"] = ""


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from gala_bench import cell as cells

    c = cells.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("gala_bench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    print(f"gala_bench: {args.workload} seed {args.seed} on {_power_limit()}", file=sys.stderr)
    result = cells.run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda",
                            t_start=T_START)
    banned = cells.banned_modules()
    if banned:
        print(f"gala_bench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    print(f"gala_bench: {time.perf_counter() - T_START:.1f} s in all", file=sys.stderr)
    print("\n".join(cells.summary_lines(result)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
