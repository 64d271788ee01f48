"""The command itself: it refuses to run without the cards a cell asks
for, and on a card every cell runs and comes out correct (``cuda``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seconds, trace=0, timeout=600):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(CELLS[0], 1)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _run(cell, 2, trace)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out
    assert list(out)[-1] == "checks"
