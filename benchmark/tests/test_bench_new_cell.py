"""A configuration whose entry into the program is not ``BpOsdDecoder``
joins the benchmark with new files only: in a copy of the benchmark's
root, a scratch cell (its configuration, traffic, driver, limits, a
``program/<entry>.py`` that builds ``BpDecoder``, and a per-layer metric
that reads the entry's root span) is added beside the others, and
``harness.run`` drives it on the CPU with the span slice. Its result comes
out correct, and the span the entry's call opens at the top level is read
as the call's root."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("ldpc_tpu_torch")

ROOT = Path(__file__).resolve().parents[2]
CELL = "scratch_bp.batch"

FILES = {
    "benchmark/configs/scratch_bp.json": {
        "name": "scratch_bp", "reduced": [],
        "code": {"family": "toric", "distance": 6},
        "noise": {"channel": "bsc", "error_rate": 0.05},
        "decoder": {"class": "BpDecoder", "bp_method": "minimum_sum", "ms_scaling_factor": 0.625,
                    "schedule": "parallel", "max_iter": 10}},
    "benchmark/traffic/scratch_bp.json": {
        "driver": "scratch_bp", "batch": 32, "pool": 2, "warm_calls": 1, "check_calls": 2,
        "trace_calls": 2, "gap_calls": 1, "sync_calls": 1, "span_calls": 3},
    "benchmark/limits/scratch_bp.batch.json": {"decodings_off_pct": 0.0},
}

PROGRAM = '''"""The scratch cell's entry: ``BpDecoder``."""


def bp_decoder(cfg, hx, device):
    import ldpc_tpu_torch

    d = cfg["decoder"]
    return ldpc_tpu_torch.BpDecoder(
        hx, error_rate=cfg["noise"]["error_rate"], max_iter=d["max_iter"],
        bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
        schedule=d["schedule"], device=device)
'''

DRIVER = '''"""Closed loop of ``BpDecoder.decode_batch``, judged against the plain
reference's min-sum BP."""

import numpy as np
import torch

from benchmark import inputs, judge
from benchmark.program import bp
from benchmark.reference import bp as ref_bp
from benchmark.reference import codes
from benchmark.reference.decode import channel_llr


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.hx = codes.build(cfg["code"])
        self.decoder = bp.bp_decoder(cfg, self.hx, device)
        self.pool = inputs.syndrome_pool(self.hx, cfg["noise"]["error_rate"], traffic["batch"],
                                         traffic["pool"], seed, device)

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.call(i)

    def call(self, i):
        k = i % len(self.pool)
        out = self.decoder.decode_batch(self.pool[k])
        return out.shape[0], (k, out)

    @staticmethod
    def keep(out):
        k, x = out
        return k, np.array(x, copy=True)

    def free(self):
        self.decoder = None

    def judge(self, kept):
        syn = np.concatenate([self.pool[k] for k, _ in kept])
        d = self.cfg["decoder"]
        g = ref_bp.graph(self.hx, self.device)
        llr0 = torch.full((g.n,), channel_llr(self.cfg["noise"]["error_rate"]),
                          dtype=torch.float32, device=self.device)
        want = ref_bp.min_sum(g, torch.from_numpy(syn).to(self.device), llr0,
                              d["ms_scaling_factor"], d["max_iter"]).decoding.cpu().numpy()
        got = np.concatenate([x for _, x in kept])
        return judge.decodings(self.hx, syn, got, want, self.device)

    def failed(self, numbers):
        return 0

    def work(self, calls):
        return {}

    def sizes(self):
        return {}
'''

METRIC = '''"""Host ms a call in the calls' root spans, whatever their name."""

from benchmark.yardstick import spans as sp


def read(ctx):
    roots = sp.roots(ctx.spans)
    return sum(s.end_ns - s.start_ns for s in roots) / 1e6 / ctx.span_calls if roots else None
'''


def _scratch_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "scratch_bp", "source": "a test's scratch configuration",
                            "file": "benchmark/configs/scratch_bp.json", "reduced": [],
                            "why": "an entry other than BpOsdDecoder"})
    spec["workloads"].append({"name": CELL, "config": "scratch_bp", "traffic": "scratch_bp",
                              "chips": 1, "why": "BpDecoder.decode_batch"})
    spec["per_layer"].append({"name": "scratch.root_ms", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "decoder API",
                              "moves": "shots_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for rel, data in FILES.items():
        (root / rel).write_text(json.dumps(data))
    for rel, text in (("benchmark/program/bp.py", PROGRAM),
                      ("benchmark/drivers/scratch_bp.py", DRIVER),
                      ("benchmark/metrics/scratch.root_ms.py", METRIC)):
        assert not (ROOT / rel).exists()
        (root / rel).write_text(text)
    return root


def test_a_cell_of_new_files_runs_with_its_own_entry(tmp_path):
    root = _scratch_root(tmp_path)
    code = ("import json; from benchmark import harness; "
            f"print(json.dumps(harness.run({CELL!r}, {2**31 + 21}, 0.3, True, device='cpu')))")
    # the copy's ``benchmark`` package first (the working directory), the port after it
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert list(out)[-2:] == ["program", "checks"]
    # BpDecoder's call opens one span at the top level, its prior's copy
    spans = out["program"]["spans"]
    assert spans["sync.prior_h2d"]["spans"] == 3
    assert out["program"]["anchor"] == {"device_events": 0, "calls": 3}
    assert out["metrics"]["scratch.root_ms"]["value"] == pytest.approx(
        spans["sync.prior_h2d"]["ms"])
    assert out["program"]["counters"] == {"sync.prior_h2d": 1.0}
