"""The overlapping-window cell, ``surface13_phenom.owd``: on the CPU it
runs through ``harness.run`` at its traffic's ``test`` sizes with the span
slice, correct, and the program's span readings are numbers; the readers
of its device-trace metrics read numbers from a made-up slice and nothing
from none; ``program/owd.py`` is the one file beside
``program/__init__.py`` that imports the port. On a card (``cuda``), at
the traffic's own sizes, the bfloat16 control comes out not correct."""

import ast
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, judge
from benchmark.readings import readings

pytest.importorskip("ldpc_tpu_torch")

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CELL = "surface13_phenom.owd"
SEED = 2**31 + 23
DEVICE_METRICS = ("kernels.owd_bp_roofline", "kernels.osd0_roofline", "decoders.copy_ms")
SPAN_METRICS = ("owd.scan_ms", "owd.boundary_ms")
# the accepted metrics that read the cell's spans and counters too
SHARED_SPAN_METRICS = ("post.span_ms", "decoders.sync_wait_ms", "decoders.program_syncs")


def _reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read


def test_the_cells_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    own = [m["name"] for m in spec["per_layer"] if m.get("workloads") == [CELL]]
    assert own == ["kernels.owd_bp_roofline", "kernels.osd0_roofline", *SPAN_METRICS]
    assert [m["name"] for m in harness.Cell(CELL).metrics("per_layer")] == [
        "device.idle_share", "device.peak_mem_gib", "decoders.copy_ms", "decoders.host_syncs",
        "post.span_ms", "decoders.sync_wait_ms", "decoders.program_syncs",
        "device.idle_between_calls_share", *own]
    assert [m["name"] for m in harness.Cell(CELL).metrics("end_to_end")] == ["shots_per_s",
                                                                             "setup_s"]


def test_cell_runs_with_its_span_slice():
    sizes = harness.Cell(CELL).traffic["test"]
    out = harness.run(CELL, SEED, 0.2, True, device="cpu", traffic=sizes)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["checks"]["decodings_off_pct"]["value"] == 0.0
    assert out["checks"]["predictions_off"]["value"] == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(m[k] > 0 for k in SPAN_METRICS + SHARED_SPAN_METRICS), m
    assert not set(m) & set(DEVICE_METRICS)  # no device events on the CPU
    program, calls = out["program"], sizes["span_calls"]
    assert program["spans"]["owd.decode_batch"]["spans"] == calls
    assert program["spans"]["owd.scan.window"]["spans"] == 5 * calls
    c = program["counters"]
    assert c["owd.shots"] == sizes["batch"]
    assert (c["owd.windows.host"], c["owd.windows.device"], c["sync.owd_select"]) == (2, 5, 5)
    assert m["owd.scan_ms"] == pytest.approx(program["spans"]["owd.scan"]["ms"])
    syncs = sum(v for k, v in c.items() if k.startswith("sync."))
    assert m["decoders.program_syncs"] == pytest.approx(syncs)


def _windows(m, n, lanes, iters, osd, steps, pivots):
    return {"m": m, "n": n, "dc": 6, "dv": 2, "nnz": 3648, "bp_lanes": lanes,
            "bp_lane_iterations": iters, "osd_lanes": osd, "osd_steps": steps,
            "osd_pivots": pivots, "osd_pivot_words": pivots}


def test_device_readers_on_a_made_up_slice():
    windows = [_windows(624, 2032, 8192, 65000, 1800, 15000, 14000)] * 7
    events = [
        {"name": "void (anonymous namespace)::bp_warp_kernel<float, 8, true, true>(Args)",
         "cat": "kernel", "ts": 0.0, "dur": 1000.0},
        {"name": "void (anonymous namespace)::gf2_block_kernel<false, false, true, false>(Args)",
         "cat": "kernel", "ts": 1000.0, "dur": 500.0},
        {"name": "void (anonymous namespace)::gf2_warp_osd0_kernel<8>(Args)", "cat": "kernel",
         "ts": 1500.0, "dur": 500.0},
        {"name": "gf2_block_kernel<false, true, false, false>", "cat": "kernel", "ts": 2000.0,
         "dur": 9000.0},
        {"name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy", "ts": 2.0e4,
         "dur": 300.0},
        {"name": "Memcpy DtoH (Device -> Pageable)", "cat": "gpu_memcpy", "ts": 3.0e4,
         "dur": 500.0},
        {"name": "Memcpy DtoD (Device -> Device)", "cat": "gpu_memcpy", "ts": 4.0e4,
         "dur": 700.0}]
    ctx = SimpleNamespace(device_events=events, slice_calls=2, work=lambda: {"windows": windows})
    from benchmark.yardstick import owd, work

    # K1': its operations bound it here; K2': its bytes, over 1 ms of both variants
    moved, ops = owd.k1(windows)
    want = 100.0 * work.bound_s(moved, ops) / 1e-3
    assert _reader("kernels.owd_bp_roofline")(ctx) == pytest.approx(want)
    assert ops / work.OPS_PER_S > moved / work.HBM_BYTES_PER_S
    moved, ops = owd.osd0(windows)
    assert moved == 7 * (1800 * (624 + 2032 + 1) + 4 * 15000 + 4 * 2032 * 2)
    assert _reader("kernels.osd0_roofline")(ctx) == pytest.approx(
        100.0 * work.bound_s(moved, ops) / 1e-3)
    # every copy, device to device too: (300 + 500 + 700) us over 2 calls
    assert _reader("decoders.copy_ms")(ctx) == pytest.approx(0.75)
    empty = SimpleNamespace(device_events=[], slice_calls=2, work=ctx.work)
    assert all(_reader(k)(empty) is None for k in DEVICE_METRICS)


def test_span_readers_find_nothing_without_their_spans():
    ctx = SimpleNamespace(span_table={"decode_batch": {"ms": 1.0}})
    assert all(_reader(k)(ctx) is None for k in SPAN_METRICS)
    ctx = SimpleNamespace(span_table={"owd.window": {"ms": 2.0}, "owd.bookkeeping": {"ms": 0.5},
                                      "owd.scan": {"ms": 3.0}})
    assert _reader("owd.boundary_ms")(ctx) == 2.5 and _reader("owd.scan_ms")(ctx) == 3.0


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card():
    """At the traffic's own sizes (``check_calls`` calls of ``batch`` shots
    from a pool of ``pool``) the program reads 0 and the bfloat16 control
    departs on some checked shots, beyond the limit of no differing shot.
    min-sum at alpha 1 on one prior computes with multiples of one LLR,
    which bfloat16 keeps in order, so the control departs on about 2 shots
    in 10,000 (PERF.md): at the CPU test's 64 shots it reads 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = readings(CELL, SEED, 10.0, device="cuda")
    limits = harness.Cell(CELL).limits
    assert judge.verdict(r["program"], limits)[0], r
    assert r["control"]["decodings_off_pct"] > limits["decodings_off_pct"], r
    assert r["control"]["syndrome_misses"] == 0, r


def test_program_owd_is_the_new_importer_of_the_port():
    def imports_port(path):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            if any(n.split(".")[0] == "ldpc_tpu_torch" for n in names):
                return True
        return False

    users = sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
                   if p.relative_to(BENCH).parts[0] != "tests" and imports_port(p))
    assert users == ["program/__init__.py", "program/owd.py"]
