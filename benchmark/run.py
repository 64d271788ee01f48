"""The benchmark of ``ldpc_tpu_torch``: one run of one cell.

Usage, from the root of a checkout on a machine with a CUDA device:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and configurations are in ``BENCHMARK.json``; the
harness is ``benchmark/harness.py``. The last line of standard output is
the result (JSON); each compared number and its limit are the last lines
of standard error. The kernels are built into ``build/`` inside the
checkout on the first run and loaded from there after.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a run writes stays inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from benchmark import harness

    chips = next(w["chips"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card()}; torch {torch.__version__}", file=sys.stderr, flush=True)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    w = out["window"]
    if "slice" in w:
        print(f"profiled slice: {w['slice']['shots_per_s']} shots/s against the window's "
              f"{out['attempted'] / w['seconds']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
