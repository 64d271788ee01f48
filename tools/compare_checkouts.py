"""Time K1' at the main path's first launch in several checkouts, in turns,
in one call on one NVIDIA GPU.

Usage: ``python tools/compare_checkouts.py CHECKOUT [CHECKOUT ...]`` from the
repository root, on a machine with a CUDA device and ``nvcc``; give the
checkouts in the order to run them (e.g. parent, change, change, parent).

Each run is a process of its own that imports the named checkout's
``ldpc_tpu_torch`` (which builds that checkout's kernels into its own
``build/``) and times K1' on the main path's first launch: the 65,536 d=13
surface-code syndromes of ``chip_smoke.py`` (BSC p=0.01, numpy seed 7), an
(n,) prior, <=6 iterations, min-sum 0.625. Every timed launch is first held
against the plain version; the time is device time, 10 launches in one CUDA
graph replayed 3 times, taken 3 times. It prints the card's name and power
limit, one line per run, and writes all runs to
``chiprun_out/compare_checkouts.json``.
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import json
import numpy as np
import torch
import ldpc_tpu_torch
from ldpc_tpu_torch.codes import surface_code
from ldpc_tpu_torch.ops import bp_cuda
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, channel_llr
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch

code = surface_code(13)
graph = compile_pcm(code.hx)
rng = np.random.default_rng(7)
errors = (rng.random((65536, graph.n)) < 0.01).astype(np.uint8)
dev = torch.device("cuda")
syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
tg = graph_to_torch(graph, dev)
llr0 = torch.from_numpy(channel_llr(np.full(graph.n, 0.01))).to(dev)


def launch():
    return bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 6, 0.625)


ker = launch()
ref = bp_cuda.bp_parallel_reference(tg, syn, llr0, MINIMUM_SUM, 6, 0.625)
torch.cuda.synchronize()
if not all(torch.equal(a, b) for a, b in zip(ker, ref)):
    raise SystemExit("K1' differs from its plain version")


def device_ms(calls=10, replays=3):
    launch()
    torch.cuda.synchronize()
    graph_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_):
        for _ in range(calls):
            launch()
    graph_.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph_.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


print(json.dumps({"package": ldpc_tpu_torch.__file__, "ms": [device_ms() for _ in range(3)]}))
"""


def main() -> int:
    checkouts = sys.argv[1:]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for checkout in checkouts:
        root = str(Path(checkout).resolve())
        out = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        run = {"checkout": checkout, **json.loads(out.stdout.strip().splitlines()[-1])}
        runs.append(run)
        print(f"[k1_main_time] checkout={checkout} ms={run['ms']}", flush=True)
    path = Path("chiprun_out/compare_checkouts.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
