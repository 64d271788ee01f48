"""The sliding-window cell, ``surface13_analog.window``: its metrics; the
histories its driver draws; on the CPU it runs through ``harness.run`` at
its traffic's ``test`` sizes with the span slice, correct, with the window
engine's spans and counters read; the readers of its new metrics read
numbers from a made-up slice and nothing from none. On a card (``cuda``),
at the traffic's own sizes, the program reads 0 and the bfloat16 control
is not correct, and the recorder's ``launch.bp_parallel.lane_prior`` count
equals the trace's K1' events on a per-lane prior, 7 a call."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, judge
from benchmark.readings import readings

pytest.importorskip("ldpc_tpu_torch")

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CELL = "surface13_analog.window"
SEED = 2**31 + 26
WINDOWS = 7
SPAN_METRICS = ("window.step_ms", "decoders.sync_wait_ms", "decoders.program_syncs")


def _reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def test_the_cells_metrics():
    cell = harness.Cell(CELL)
    assert [m["name"] for m in cell.metrics("per_layer")] == [
        "device.idle_share", "device.peak_mem_gib", "decoders.copy_ms", "decoders.sync_wait_ms",
        "decoders.program_syncs", "device.idle_between_calls_share", "kernels.osd0_roofline",
        "kernels.window_bp_roofline", "window.step_ms"]
    assert [m["name"] for m in cell.metrics("end_to_end")] == ["shots_per_s", "setup_s"]
    assert cell.cfg["windows"] == (cell.cfg["rounds"] - cell.cfg["window"]) // cell.cfg[
        "commit"] + 1 == WINDOWS


def test_histories_are_the_configurations():
    """The syndrome bit is ``a < 0``, the last round's values are exactly
    ``1 - 2 s``, the noisy rounds' values spread about their sign by
    sigma, and a generator seeded alike draws the same batch."""
    from ldpc_tpu_torch.monte_carlo_simulation.simulation_utils import get_sigma_from_syndr_er

    cell = harness.Cell(CELL)
    driver = harness.load_module(BENCH / "drivers" / "window.py")
    cfg = cell.cfg
    assert driver.ref.sigma_from_rate(cfg["noise"]["q"]) == cfg["noise"]["sigma"] == (
        get_sigma_from_syndr_er(cfg["noise"]["q"]))
    hx = driver.codes.build(cfg["code"])
    gen = torch.Generator()
    gen.manual_seed(5)
    syn, ana = driver.histories(hx, cfg["rounds"], 0.02, cfg["noise"]["sigma"], 256, gen, "cpu")
    assert syn.dtype == torch.uint8 and ana.dtype == torch.float32
    assert syn.shape == ana.shape == (256, hx.shape[0], cfg["rounds"])
    assert torch.equal(syn, (ana < 0).to(torch.uint8))
    last = ana[:, :, -1]
    assert bool(((last == 1.0) | (last == -1.0)).all())
    assert bool((ana[:, :, :-1].abs() != 1.0).all())
    # the same generator again: the same pool; the noisy readings spread by sigma
    gen.manual_seed(5)
    again = driver.histories(hx, cfg["rounds"], 0.02, cfg["noise"]["sigma"], 256, gen, "cpu")
    assert torch.equal(again[0], syn) and torch.equal(again[1], ana)
    noisy = ana[:, :, :-1]
    spread = float((noisy - torch.sign(noisy)).std())
    assert abs(spread / cfg["noise"]["sigma"] - 1.0) < 0.05


def test_cell_runs_with_its_span_slice():
    sizes = harness.Cell(CELL).traffic["test"]
    out = harness.run(CELL, SEED, 0.2, True, device="cpu", traffic=sizes)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert [out["checks"][k]["value"] for k in ("decodings_off_pct", "iterations_off")] == [0.0, 0]
    assert out["attempted"] % sizes["batch"] == 0 and out["attempted"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(m[k] > 0 for k in SPAN_METRICS), m
    assert m["decoders.program_syncs"] == WINDOWS
    assert not {"kernels.window_bp_roofline", "kernels.osd0_roofline"} & set(m)  # no kernel
    program, calls = out["program"], sizes["span_calls"]
    spans = program["spans"]
    assert spans["window.call"]["spans"] == spans["window.decode"]["spans"] == calls
    assert spans["window.call"]["ms"] >= spans["window.decode"]["ms"]
    assert spans["window.step"]["spans"] == spans["sync.window_select"]["spans"] == (
        WINDOWS * calls)
    assert m["window.step_ms"] == pytest.approx(spans["window.step"]["ms"])
    c = program["counters"]
    assert c["window.shots"] == sizes["batch"]
    assert c["window.windows"] == c["window.windows.analog"] == c["sync.window_select"] == WINDOWS
    assert c["window.lanes.post"] == c["lanes.osd"] > 0
    assert not any(k.startswith("launch.") for k in c)  # no kernel on the CPU


def _windows(lanes, iters, osd, steps, pivots):
    return {"m": 624, "n": 1876, "dc": 6, "dv": 4, "nnz": 3492, "bp_lanes": lanes,
            "bp_lane_iterations": iters, "osd_lanes": osd, "osd_steps": steps,
            "osd_pivots": pivots, "osd_pivot_words": pivots}


def test_lane_prior_events_and_their_roofline():
    reader = _reader("kernels.window_bp_roofline")
    names = {"void (anonymous namespace)::bp_warp_kernel<float, 4, true, false, true>(Args<float>)":
             True,
             "void (anonymous namespace)::bp_warp_kernel<float, 4, true, false, false>(Args<float>)":
             False,
             "bp_warp_kernel<float, 8, true, true, true>": True,
             "bp_warp_kernel<double, 4, true, true, false>": False,
             "gf2_block_kernel<false, false, true, false>": False}
    assert {k: reader.lane_prior(k) for k in names} == names
    windows = [_windows(8192, 60000, 900, 200000, 150000)] * WINDOWS
    events = [{"name": k, "cat": "kernel", "ts": 0.0, "dur": 500.0} for k in names]
    ctx = SimpleNamespace(device_events=events, slice_calls=1, work=lambda: {"windows": windows})
    from benchmark.yardstick import window, work

    moved, ops = window.k1(windows)
    # each lane's (n,) float32 prior is read once beside K1''s other bytes
    assert moved == WINDOWS * (work.k1_bytes(624, 1876, 6, 4, 8192, 1) + 4.0 * 8192 * 1876)
    assert ops == WINDOWS * work.k1_ops(3492, 1876, 60000)
    # two lane-prior launches of 500 us each
    assert reader.read(ctx) == pytest.approx(100.0 * work.bound_s(moved, ops) / 1e-3)
    assert reader.read(SimpleNamespace(device_events=events[1:2], work=ctx.work)) is None


def test_span_reader_finds_nothing_without_its_span():
    read = _reader("window.step_ms").read
    assert read(SimpleNamespace(span_table={"decode_batch": {"ms": 1.0}})) is None
    assert read(SimpleNamespace(span_table={"window.step": {"ms": 2.5}})) == 2.5


@pytest.mark.cuda
def test_control_and_launches_on_the_card():
    """At the traffic's own sizes: the program reads 0, the bfloat16
    control is not correct, and two calls' K1' launches on a per-lane prior
    (7 a call, one a window) are the trace's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from benchmark import program
    from benchmark.yardstick import trace as tr

    r = readings(CELL, SEED, 5.0, device="cuda")
    limits = harness.Cell(CELL).limits
    assert judge.verdict(r["program"], limits)[0], r
    assert not judge.verdict(r["control"], limits)[0], r

    cell = harness.Cell(CELL)
    driver = cell.driver_module.Driver(cell.cfg, cell.traffic, SEED, "cuda")
    driver.call(0)  # builds the kernels
    torch.cuda.synchronize()
    program.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        program.record(True)
        try:
            for i in (1, 2):
                driver.call(i)
            torch.cuda.synchronize()
        finally:
            program.record(False)
    counters = program.drain().counters
    device_events, _ = tr.events(prof)
    lane_prior = _reader("kernels.window_bp_roofline").lane_prior
    k1 = [e["name"] for e in device_events if e["cat"] == "kernel" and "bp_warp_kernel" in e["name"]]
    assert sum(map(lane_prior, k1)) == len(k1) == counters["launch.bp_parallel.lane_prior"]
    assert counters["launch.bp_parallel"] == 2 * WINDOWS == counters["window.windows.analog"]
    assert counters["sync.window_select"] == 2 * WINDOWS
    assert counters["window.lanes.post"] == counters["lanes.osd"] > 0
    assert np.isclose(counters["window.shots"], 2 * cell.traffic["batch"])
