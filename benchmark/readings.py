"""The readings that a cell's limits are set from, in one process.

Usage, from the root of a checkout on a machine with a CUDA device:

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 --seconds 2

For each seed it builds the cell's driver, runs its closed loop for
``--seconds``, keeps ``check_calls`` calls as a run does and prints one
JSON line: the compared numbers of the program (the lower readings) and of
the control, the plain reference in bfloat16 put in the program's place on
the same kept calls (the upper readings). The benchmark's runs never run
the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, seconds: float, device="cuda", traffic=None,
             control: bool = True) -> dict:
    import torch

    from benchmark import harness

    cell = harness.Cell(workload, ROOT, traffic)
    t = cell.traffic
    driver = cell.driver_module.Driver(cell.cfg, t, seed, device)
    driver.warm()
    keep = harness.Reservoir(t["check_calls"], seed)
    i, t0 = t["warm_calls"], time.perf_counter()
    while True:
        keep.offer(driver.keep, driver.call(i)[1])
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    driver.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed, "calls": i - t["warm_calls"],
           "program": driver.judge(keep.items)}
    if control:
        out["control"] = driver.judge(keep.items, control=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--no-control", action="store_true")
    args = parser.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, args.seconds, control=not args.no_control)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
