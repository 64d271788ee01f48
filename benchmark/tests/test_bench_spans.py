"""The span slice's readings on a made-up slice (``harness.recorded``,
``yardstick/spans.py`` and the metric readers that take them): two calls,
with the second call's device timeline on the host's clock, late or early,
as the profiler's device clock strays; and the readings with nothing to
read."""

from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import pytest

from benchmark import harness
from benchmark.yardstick import spans as sp

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READINGS = ("post.span_ms", "decoders.sync_wait_ms", "decoders.program_syncs",
            "device.idle_between_calls_share")


class Span(NamedTuple):  # the fields the program's recorder drains
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    attrs: dict


def _read(ctx) -> dict:
    return {m: harness.load_module(METRICS / f"{m}.py").read(ctx) for m in READINGS}


def _made_up_slice(stray_us, root="decode_batch"):
    """Two calls of 10 ms, 2 ms apart, in a 25 ms slice, and their device
    events in microseconds from the trace's base; ``stray_us`` moves the
    second call's device events (each by its own amount, by kernel name)
    off the host timeline."""
    base_ns = 1_790_000_000_000_000_000
    spans, evs = [], []
    for c in range(2):
        o = 1000 + 12000 * c  # the call's start, us after the base
        top = len(spans)

        def at(name, a, b, parent):
            spans.append(Span(name, base_ns + (o + a) * 1000, base_ns + (o + b) * 1000, parent,
                              c, {}))
            return len(spans) - 1

        at(root, 0, 10000, -1)
        at("sync.x", 500, 1000, top)
        osd = at("osd", 2000, 9000, top)
        at("osd.elim", 2100, 2900, osd)
        at("osd.sweep", 3000, 8000, osd)
        for k, (name, cat, a, dur, launch) in enumerate([
                ("bp_warp_kernel", "kernel", 100, 2400, 50),
                ("gf2_warp_export_kernel<false, 16>", "kernel", 3000, 2000, 2200),
                ("Memcpy DtoH", "gpu_memcpy", 9500, 400, 9400)]):
            corr = 10 * c + k
            move = stray_us.get(name, 0) if c == 1 else 0
            evs.append({"ph": "X", "cat": cat, "name": name, "ts": o + a + move, "dur": dur,
                        "args": {"correlation": corr}})
            evs.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                        "ts": o + launch, "dur": 5, "args": {"correlation": corr}})
    trace = {"baseTimeNanoseconds": base_ns, "traceEvents": evs}
    return spans, {"sync.x": 2, "osd.chunks": 2}, (base_ns, base_ns + 25_000_000), trace


def us(x):  # microseconds since 1970 in float64: steps of 0.25 us
    return pytest.approx(x, abs=0.5)


ALL = ("bp_warp_kernel", "gf2_warp_export_kernel<false, 16>", "Memcpy DtoH")


@pytest.mark.parametrize("stray,anchor", [
    # the device timeline on the host's: nothing moves
    ({}, {"launch_to_start_min_us": us(50), "end_past_call_max_us": us(-100),
          "calls_moved": 0, "shift_us": [0.0, 0.0]}),
    # 3 ms late: the copy its last sync waited for goes back to the call's end
    (dict.fromkeys(ALL, 3000),
     {"launch_to_start_min_us": us(50), "end_past_call_max_us": us(2900), "calls_moved": 1,
      "shift_us": [us(-2900), 0.0]}),
    # 2 ms early: the kernel that started soonest after its launch goes to it
    (dict.fromkeys(ALL, -2000),
     {"launch_to_start_min_us": us(-1950), "end_past_call_max_us": us(-100), "calls_moved": 1,
      "shift_us": [0.0, us(1950)]}),
], ids=["on_clock", "late", "early"])
@pytest.mark.parametrize("root", ["decode_batch", "owd.decode_batch"])
def test_span_readings_on_a_made_up_slice(stray, anchor, root):
    spans, counters, slice_ns, trace = _made_up_slice(stray, root)
    r = harness.recorded(spans, counters, 2, slice_ns, trace)
    got = _read(SimpleNamespace(**r))
    assert got["post.span_ms"] == pytest.approx(7.0)
    assert got["decoders.sync_wait_ms"] == pytest.approx(0.5)
    assert got["decoders.program_syncs"] == 1.0
    # idle: 25,000 us less 2 x 4,800 busy; 2 x 5,200 of it inside the calls
    assert got["device.idle_between_calls_share"] == pytest.approx((15400 - 10400) / 15400)
    assert r["span_table"]["osd"]["self_ms"] == pytest.approx(7.0 - 0.8 - 5.0)
    assert r["span_table"][root]["idle_ms"] == pytest.approx(5.2)
    assert r["span_anchor"] == {"device_events": 6, "calls": 2, "calls_without_shift": 0, **anchor}


def test_span_readings_with_nothing_to_read():
    """No device events, no spans, or a call whose device timeline no
    shift puts back (a kernel before its launch and a copy after the
    call's end): the readings that need them are None."""
    spans, counters, slice_ns, trace = _made_up_slice({})
    bare = harness.recorded(spans, counters, 2, slice_ns, None)
    assert _read(SimpleNamespace(**bare))["device.idle_between_calls_share"] is None
    assert _read(SimpleNamespace(**bare))["post.span_ms"] == pytest.approx(7.0)
    assert bare["span_anchor"] == {"device_events": 0, "calls": 2}
    assert "idle_ms" not in bare["span_table"]["osd"]
    empty = harness.recorded([], {}, 2, slice_ns, trace)
    assert all(v is None for v in _read(SimpleNamespace(**empty)).values())
    spans, counters, slice_ns, trace = _made_up_slice({"bp_warp_kernel": -2000,
                                                       "Memcpy DtoH": 3000})
    torn = harness.recorded(spans, counters, 2, slice_ns, trace)
    got = _read(SimpleNamespace(**torn))
    assert got["device.idle_between_calls_share"] is None
    assert torn["span_anchor"]["calls_without_shift"] == 1
    assert got["decoders.sync_wait_ms"] == pytest.approx(0.5)


def test_span_table_on_made_up_spans():
    spans = [Span("call", 0, 10_000_000, -1, 0, {}),  # 10 ms
             Span("stage", 1_000_000, 5_000_000, 0, 0, {}),  # 4 ms
             Span("sync.x", 2_000_000, 3_000_000, 1, 0, {}),  # 1 ms
             Span("call", 20_000_000, 30_000_000, -1, 1, {})]
    # device busy (us): 0-2 ms and 4-12 ms, then 25-26 ms
    busy = [(0.0, 2000.0), (1500.0, 1800.0), (4000.0, 12000.0), (25000.0, 26000.0)]
    t = sp.span_table(spans, calls=2, device_us=busy)
    assert t["call"]["spans"] == 2 and t["call"]["ms"] == pytest.approx(10.0)
    assert t["call"]["self_ms"] == pytest.approx((10 - 4 + 10) / 2)
    # idle in the calls: 2-4 ms of the first, 9 of the second's 10
    assert t["call"]["idle_ms"] == pytest.approx((2 + 9) / 2)
    assert t["stage"]["self_ms"] == pytest.approx(1.5)
    assert t["stage"]["idle_ms"] == pytest.approx(1.0)  # 2-4 ms
    assert t["sync.x"]["idle_ms"] == pytest.approx(0.5)
    assert "idle_ms" not in sp.span_table(spans)["call"]
    assert sp.idle_us(sp.union(busy), 0.0, 30000.0) == pytest.approx(30000 - 11000)


def test_toric_cell_span_slice_on_the_cpu():
    """The toric cell through ``harness.run`` on the CPU at its test sizes:
    the program's spans and counters of the span slice, in the result's
    ``program`` key and in the readings that need no device events."""
    pytest.importorskip("ldpc_tpu_torch")
    cell = "toric20_bsc.batch_cs5"
    sizes = harness.Cell(cell).traffic["test"]
    out = harness.run(cell, 2**31 + 5, 0.2, True, device="cpu", traffic=sizes)
    calls, program = sizes["span_calls"], out["program"]
    assert list(out)[-2:] == ["program", "checks"]
    assert program["spans"]["decode_batch"]["spans"] == calls
    assert program["counters"]["lanes.in"] == sizes["batch"]
    assert program["anchor"] == {"device_events": 0, "calls": calls}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["decoders.program_syncs"] == 10.0
    assert m["post.span_ms"] > 0 and m["decoders.sync_wait_ms"] > 0
    assert "device.idle_between_calls_share" not in m and "kernels.sweep_roofline" not in m
