"""The port's in-program recorder (``ldpc_tpu_torch.utils.profiling``) on
the CPU: off, the decode path records nothing and makes no annotation; on,
``BpOsdDecoder.decode_batch`` with OSD-CS gives one span tree a call whose
counters agree with the batch's properties; decodings are the same either
way; the spans share the profiler's Chrome-trace clock; the union-find and
window sync sites count under their causes; the overlapping-window
decoder's span tree and counters, and its sync sites reached alike with
the recorder on and off; the device Monte-Carlo's span tree, its counters
against the pulled counter vector, and its one sync site reached alike on
and off; the sliding-window decoder's span tree and counters (one
``window.decode`` a call over a ``window.step`` a window, the lanes it hands
to OSD-0 as ``sync.window_select`` selects them), ``DeviceQss``'s window
steps without a root of the window decoder's, and the OWD's counts without
any of the window engine's. The spans are read by the benchmark's reader
(``benchmark/yardstick/spans.py``), the one the traced benchmark run uses:
on made-up spans and device events, and on recorded CPU calls.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import ldpc_tpu_torch
from benchmark.yardstick import spans as sp
from ldpc_tpu_torch.ckt_noise import base_overlapping_window_decoder as owd_base
from ldpc_tpu_torch.codes import rep_code, surface_code, toric_code
from ldpc_tpu_torch.monte_carlo_simulation import device_mc
from ldpc_tpu_torch.monte_carlo_simulation.simulation_utils import get_sigma_from_syndr_er
from ldpc_tpu_torch.ops import osd as osd_ops
from ldpc_tpu_torch.ops import uf
from ldpc_tpu_torch.parallel import window
from ldpc_tpu_torch.utils import profiling as pf

B = 96
P = 0.08
CHUNK_ELEMENTS = osd_ops._CHUNK_ELEMENTS


@pytest.fixture(autouse=True)
def recorder_off():
    pf.record(False)
    pf.drain()
    yield
    pf.record(False)
    pf.drain()


def _toric():
    hx = toric_code(6).hx.toarray().astype(np.uint8)
    rng = np.random.default_rng(6)
    err = (rng.random((B, hx.shape[1])) < P).astype(np.uint8)
    syn = (err @ hx.T % 2).astype(np.uint8)
    syn[:3] = 0  # zero-syndrome lanes converge without OSD
    return hx, syn


def _decoder(hx):
    return ldpc_tpu_torch.BpOsdDecoder(
        hx, error_rate=P, max_iter=10, bp_method="ms", ms_scaling_factor=0.625,
        osd_method="osd_cs", osd_order=5, device="cpu")


def _decode(dec, syn, on: bool):
    pf.record(on)
    try:
        out = dec.decode_batch(syn)
    finally:
        pf.record(False)
    return out, pf.drain()


def test_off_records_nothing_and_sites_are_null():
    hx, syn = _toric()
    _, rec = _decode(_decoder(hx), syn, False)
    assert rec.spans == [] and rec.counters == {}
    assert pf.span("decode_batch", lanes=3) is pf.NULL_SPAN
    assert pf.sync("output") is pf.NULL_SPAN
    with pf.span("x"):
        pf.count("y", 5)
    assert pf.drain() == pf.Recording([], {})


@pytest.mark.parametrize("on", [False, True])
def test_annotations_only_while_on(on, monkeypatch):
    """Off, the decode path makes no ``record_function`` or NVTX call; on,
    every span enters one."""
    calls = []

    class Stub:
        def __init__(self, name, *args, **kwargs):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Stub)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Stub)
    monkeypatch.setattr(torch.cuda.nvtx, "range", Stub)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(name))
    hx, syn = _toric()
    _, rec = _decode(_decoder(hx), syn, on)
    assert calls == ([s.name for s in rec.spans] if on else [])


# the OSD sweep in one chunk (the default) and in chunks of a few lanes
@pytest.mark.parametrize("chunk_elements", [CHUNK_ELEMENTS, 1 << 14])
def test_span_tree_of_a_call(chunk_elements, monkeypatch):
    monkeypatch.setattr(osd_ops, "_CHUNK_ELEMENTS", chunk_elements)
    hx, syn = _toric()
    dec = _decoder(hx)
    calls = 2
    pf.record(True)
    for _ in range(calls):
        dec.decode_batch(syn)
    pf.record(False)
    spans, counters = pf.drain()

    roots = [s for s in spans if s.parent < 0]
    assert [r.name for r in roots] == ["decode_batch"] * calls
    assert [r.call for r in roots] == list(range(calls))
    assert all(r.attrs == {"lanes": B} for r in roots)
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert s.call == p.call

    def children(name):
        return [s.name for s in spans
                if s.parent >= 0 and spans[s.parent].name == name and s.call == 0]

    assert children("decode_batch") == ["sync.syndromes_h2d", "bp.phase1", "bp.phase2", "osd",
                                        "decoder.merge", "decoder.store", "decoder.d2h"]
    sweeps = [s for s in spans if s.name == "osd.sweep"]
    chunks = counters["osd.chunks"]
    assert children("osd") == ["osd.order", "osd.elim"] + ["osd.sweep"] * (chunks // calls)
    assert len(sweeps) == chunks
    assert (chunks > calls) == (chunk_elements < CHUNK_ELEMENTS)
    assert [s.attrs["chunk"] for s in sweeps] == list(range(chunks // calls)) * calls

    failed = int((~dec.converge_batch).sum())
    assert failed > 0 and dec.converge_batch[:3].all()
    assert counters["lanes.in"] == calls * B
    assert counters["lanes.osd"] == calls * failed
    assert sum(s.attrs["lanes"] for s in sweeps) == calls * failed
    assert [s.attrs["lanes"] for s in spans if s.name == "osd"] == [failed] * calls
    assert counters["lanes.phase2"] >= counters["lanes.osd"]
    # each sync cause: a span and a count
    syncs = {k: v for k, v in counters.items() if k.startswith("sync.")}
    assert syncs == {"sync.syndromes_h2d": calls, "sync.prior_h2d": 2 * calls,
                     "sync.phase1_compact": calls, "sync.phase2_compact": calls,
                     "sync.store_converge": calls, "sync.store_iter": calls,
                     "sync.store_llr0": calls, "sync.bp_row0": calls, "sync.output": calls}
    for name, n in syncs.items():
        assert sum(s.name == name for s in spans) == n


@pytest.mark.parametrize("bit_packed_output", [False, True])
def test_decodings_equal_with_recorder_on_and_off(bit_packed_output):
    hx, syn = _toric()
    dec = _decoder(hx)
    got = {}
    for on in (False, True, False):
        pf.record(on)
        out = dec.decode_batch(syn, bit_packed_output=bit_packed_output)
        pf.record(False)
        got.setdefault(on, []).append((out, dec.osd0_decoding_batch, dec.converge_batch.copy(),
                                       dec.iter_batch.copy(), dec.log_prob_ratios.copy()))
    pf.drain()
    for a, b in zip(got[False][0], got[True][0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(got[False][0], got[False][1]):
        assert np.array_equal(a, b)


def test_drain_empties_the_recorder():
    pf.record(True)
    with pf.span("a", lanes=2):
        with pf.sync("b"):
            pass
    with pf.span("c"):
        pass
    pf.count("d", 3)
    first = pf.drain()
    assert [(s.name, s.parent, s.call) for s in first.spans] == [
        ("a", -1, 0), ("sync.b", 0, 0), ("c", -1, 1)]
    assert first.counters == {"sync.b": 1, "d": 3}
    assert pf.drain() == pf.Recording([], {})
    with pf.span("e"):
        pass
    assert [(s.name, s.parent, s.call) for s in pf.drain().spans] == [("e", -1, 0)]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_tally_keeps_a_regions_counts_apart(on):
    """Inside ``tally`` the counts go to its dict, the recorder on or off,
    and none to the recorder's totals; the region's spans and syncs are not
    recorded; a nested tally keeps its own; outside, counting is as
    before."""
    pf.record(on)
    pf.count("before")
    with pf.span("outer"):
        with pf.tally() as kept:
            pf.count("launch.k", 2)
            pf.count("launch.k")
            assert pf.span("inside") is pf.NULL_SPAN
            assert pf.sync("inside") is pf.NULL_SPAN
            with pf.tally() as inner:
                pf.count("launch.j")
            pf.count("lanes.x", 5)
        pf.count("after")
    pf.record(False)
    assert kept == {"launch.k": 3, "lanes.x": 5} and inner == {"launch.j": 1}
    spans, counters = pf.drain()
    if on:
        assert [s.name for s in spans] == ["outer"]
        assert counters == {"before": 1, "after": 1}
    else:
        assert pf.drain() == pf.Recording([], {}) and (spans, counters) == ([], {})
    assert pf._tallies == 0


def test_a_tally_leaves_other_threads_alone():
    """One thread's tally takes nothing from another thread's counts and
    spans."""
    pf.record(True)
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(timeout=30)
        with pf.span("other"):
            pf.count("launch.other")
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with pf.tally() as kept:
        opened.set()
        assert done.wait(timeout=30)
        pf.count("launch.mine")
    th.join(timeout=30)
    pf.record(False)
    spans, counters = pf.drain()
    assert kept == {"launch.mine": 1}
    assert [s.name for s in spans] == ["other"] and counters == {"launch.other": 1}


def test_threads_keep_their_own_trees():
    """Threads that record at once lose no count and no span, and each
    span's parent is its own thread's."""
    threads, spans_each = 12, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for _ in range(spans_each):
                with pf.span(f"t{t}", chunk=t):
                    with pf.sync(f"t{t}"):
                        pf.count("n")

        pf.record(True)
        pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        pf.record(False)
        sys.setswitchinterval(old)
    spans, counters = pf.drain()
    assert counters["n"] == threads * spans_each
    assert len(spans) == 2 * threads * spans_each
    assert len({s.call for s in spans if s.parent < 0}) == threads * spans_each
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.name == "sync." + p.name and s.call == p.call


def test_spans_share_the_trace_clock(tmp_path):
    """A span's ``time.time_ns()`` stamps and a profiler event's ``ts +
    baseTimeNanoseconds / 1e3`` are one clock: the span holds the event."""
    x = torch.randn(256, 256)
    pf.record(True)
    with pf.trace(str(tmp_path)):
        with pf.span("matmul"):
            y = x @ x
    pf.record(False)
    (s,) = pf.drain().spans
    assert y.shape == (256, 256)
    (path,) = [f.path for f in os.scandir(tmp_path)]
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    mm = [e for e in trace["traceEvents"]
          if e.get("ph") == "X" and e.get("name") in ("aten::mm", "aten::matmul")]
    assert mm
    for e in mm:
        a = e["ts"] + base_us
        assert s.start_ns / 1e3 <= a and a + e["dur"] <= s.end_ns / 1e3, (s, e, base_us)
    # the span's annotation is in the trace too
    assert any(e.get("name") == "matmul" for e in trace["traceEvents"])


def _uf_decode():
    H = rep_code(9)
    rng = np.random.default_rng(3)
    syn = (rng.random((16, H.shape[0])) < 0.3).astype(np.uint8)
    ldpc_tpu_torch.UnionFindDecoder(H, uf_method=False, device="cpu").decode_batch(syn)
    lsd = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=2, lsd_order=0,
                                      device="cpu")
    lsd.decode_batch(syn)


def _window_decode():
    H = rep_code(5)
    rng = np.random.default_rng(4)
    syn = (rng.random((8, H.shape[0], 8)) < 0.2).astype(np.uint8)
    window.make_window_decoder(H, 4, 0.05, 0.02, device="cpu")(syn)


@pytest.mark.parametrize("causes,run", [
    (("sync.uf_any", "sync.uf_growth"), _uf_decode),
    (("sync.window_select",), _window_decode),
], ids=["uf", "window"])
def test_module_sync_sites_count_under_their_causes(causes, run):
    """Each cause's count equals its spans; LSD's growth loop counts its
    rounds under ``sync.uf_growth``."""
    pf.record(True)
    try:
        run()
    finally:
        pf.record(False)
    spans, counters = pf.drain()
    made = {c: counters.get(c, 0) for c in causes}
    assert all(v > 0 for v in made.values()), made
    for c in causes:
        assert sum(s.name == c for s in spans) == made[c]


def test_span_table_on_made_up_spans():
    S = pf.Span
    spans = [S("call", 0, 10_000_000, -1, 0, {}),  # 10 ms
             S("stage", 1_000_000, 5_000_000, 0, 0, {}),  # 4 ms
             S("sync.x", 2_000_000, 3_000_000, 1, 0, {}),  # 1 ms
             S("call", 20_000_000, 30_000_000, -1, 1, {})]
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


def _made_up_slice(stray_us):
    """Two calls of 10 ms, 2 ms apart, and their device events in
    microseconds from the trace's base; ``stray_us`` moves the second
    call's device events (each by its own amount, by kernel name) off the
    host timeline, as a stray device clock does."""
    base_ns = 1_790_000_000_000_000_000
    S, spans, evs = pf.Span, [], []
    for c in range(2):
        o = 1000 + 12000 * c  # the call's start, us after the base
        root = len(spans)

        def at(name, a, b, parent, attrs=None):
            spans.append(S(name, base_ns + (o + a) * 1000, base_ns + (o + b) * 1000, parent, c,
                           attrs or {}))
            return len(spans) - 1

        at("decode_batch", 0, 10000, -1, {"lanes": 8})
        at("sync.x", 500, 1000, root)
        osd = at("osd", 2000, 9000, root, {"lanes": 4})
        at("osd.elim", 2100, 2900, osd)
        at("osd.sweep", 3000, 8000, osd, {"lanes": 4, "chunk": 0})
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
    return spans, {"baseTimeNanoseconds": base_ns, "traceEvents": evs}


def us(x):  # microseconds since 1970 in float64: steps of 0.25 us
    return pytest.approx(x, abs=0.5)


ALL = ("bp_warp_kernel", "gf2_warp_export_kernel<false, 16>", "Memcpy DtoH")


@pytest.mark.parametrize("stray,sweep_idle,anchor", [
    # the device timeline on the host's: nothing moves
    ({}, 0.6, {"launch_to_start_min_us": us(50), "end_past_call_max_us": us(-100),
               "calls_moved": 0, "shift_us": [0.0, 0.0]}),
    # 3 ms late: the copy its last sync waited for goes back to the call's end
    (dict.fromkeys(ALL, 3000), 0.6,
     {"launch_to_start_min_us": us(50), "end_past_call_max_us": us(2900), "calls_moved": 1,
      "shift_us": [us(-2900), 0.0]}),
    # 2 ms early: the kernel that started soonest after its launch goes to it
    (dict.fromkeys(ALL, -2000), (3000 + 3050) / 10000,
     {"launch_to_start_min_us": us(-1950), "end_past_call_max_us": us(-100), "calls_moved": 1,
      "shift_us": [0.0, us(1950)]}),
], ids=["on_clock", "late", "early"])
def test_span_readings_on_a_made_up_slice(stray, sweep_idle, anchor):
    """The benchmark's reader, with the second call's device timeline on
    the host's clock, late or early: each call's device events go back
    inside it, and the span table reads them."""
    spans, trace = _made_up_slice(stray)
    busy, report = sp.device_busy(spans, trace)
    assert report == {"device_events": 6, "calls": 2, "calls_without_shift": 0, **anchor}
    t = sp.span_table(spans, 2, busy)
    assert t["osd"]["ms"] == pytest.approx(7.0)
    assert t["osd"]["self_ms"] == pytest.approx(7.0 - 0.8 - 5.0)
    # 4,800 us of the 10,000 of a call busy
    assert t["decode_batch"]["idle_ms"] == pytest.approx(5.2)
    assert t["osd.sweep"]["idle_ms"] / t["osd.sweep"]["ms"] == pytest.approx(sweep_idle)
    assert t["sync.x"]["ms"] == pytest.approx(0.5)


def test_span_readings_with_nothing_to_read():
    """No device events, no spans, or a call whose device timeline no
    shift puts back (a kernel before its launch and a copy after the
    call's end): no busy intervals, and a report that says why."""
    spans, trace = _made_up_slice({})
    assert sp.device_busy(spans, None) == (None, {"device_events": 0, "calls": 2})
    assert sp.device_busy([], trace) == (None, {"device_events": 6, "calls": 0})
    bare = sp.span_table(spans, 2, None)
    assert bare["osd"]["self_ms"] == pytest.approx(7.0 - 0.8 - 5.0)
    assert "idle_ms" not in bare["osd"]
    spans, trace = _made_up_slice({"bp_warp_kernel": -2000, "Memcpy DtoH": 3000})
    busy, report = sp.device_busy(spans, trace)
    assert busy is None
    assert report["calls_without_shift"] == 1 and report["calls_moved"] == 1


def test_recorded_cpu_calls_through_the_span_reader():
    """Two CPU ``decode_batch`` calls of 8 syndromes, recorded and read as
    the traced benchmark run reads them: a ``decode_batch`` root a call,
    10 host syncs and 8 lanes in a call."""
    hx, syn = _toric()
    dec = _decoder(hx)
    calls = 2
    pf.record(True)
    try:
        for _ in range(calls):
            dec.decode_batch(syn[:8])
    finally:
        pf.record(False)
    spans, counters = pf.drain()
    assert [r.name for r in sp.roots(spans)] == ["decode_batch"] * calls
    t = sp.span_table(spans, calls)
    assert t["decode_batch"]["spans"] == calls
    assert sum(v for k, v in counters.items() if k.startswith("sync.")) == 10 * calls
    assert sum(t[k]["spans"] for k in t if k.startswith("sync.")) == 10 * calls
    assert counters["lanes.in"] == 8 * calls
    assert t["osd"]["ms"] > 0 and t["decode_batch"]["self_ms"] > 0
    assert not any(k.startswith("launch.") for k in counters)  # no kernel on the CPU
    assert not pf._on


# ---------------------------------------------------------------------------
# The overlapping-window decoder's spans and counters (d=5, 10 rounds:
# windows 0 and 3 in the host loop, 1 and 2 on the device; see
# tests/test_torch_owd_phenom.py)

OWD_B = 96  # test_torch_owd_phenom.B


def _owd(calls: int, on: bool, path: str = "device"):
    """``calls`` calls of the small OWD experiment with the recorder on or
    off: the outputs, the recording, the sync sites reached and the
    reference's work."""
    from test_torch_owd_phenom import _decoder, _experiment, _quiet, _reference

    dem, model, shots = _experiment()
    assert shots.shape[0] == OWD_B
    dec = _decoder(model, path)
    dec.decode_batch(shots.copy())  # builds the boundary windows' decoders
    sites = []
    plain = pf.sync

    def counted(cause):
        sites.append(cause)
        return plain(cause)

    outs = []
    pf.record(on)
    try:
        for mod in (owd_base, window):
            mod.sync = counted
        for _ in range(calls):
            outs.append(_quiet(dec.decode_batch, shots.copy(), return_corrections=True))
    finally:
        pf.record(False)
        owd_base.sync = window.sync = plain
    return outs, pf.drain(), sites, _reference(dem, shots)[1]


def test_owd_span_tree_of_a_call():
    calls = 2
    _, (spans, counters), _, work = _owd(calls, True)
    roots = [s for s in spans if s.parent < 0]
    assert [r.name for r in roots] == ["owd.decode_batch"] * calls
    assert all(r.attrs == {"lanes": OWD_B} for r in roots)
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and s.call == p.call

    def children(name, call=0):
        return [s.name for s in spans
                if s.parent >= 0 and spans[s.parent].name == name and s.call == call]

    assert children("owd.decode_batch") == [
        "owd.h2d", "owd.window", "owd.scan", "owd.bookkeeping", "owd.window", "owd.predict",
        "owd.d2h"]
    assert children("owd.window") == ["decode_batch"] * 2
    assert children("owd.scan") == ["owd.scan.window"] * 2
    assert children("owd.h2d") == ["sync.owd_shots_h2d"]
    assert children("owd.d2h") == ["sync.owd_predictions_d2h", "sync.owd_corr_d2h"]
    # each device window's lane selection, then OSD-0 on its unconverged lanes
    assert children("owd.scan.window") == sum(
        (["sync.owd_select"] + ["osd"] * (work[w]["osd_lanes"] > 0) for w in (1, 2)), [])
    osd0 = work[1]["osd_lanes"] + work[2]["osd_lanes"]
    assert counters["owd.lanes.osd0"] == calls * osd0 > 0
    assert counters["owd.shots"] == calls * OWD_B
    assert counters["owd.windows.host"] == 2 * calls
    assert counters["owd.windows.device"] == 2 * calls
    assert counters["lanes.in"] == 2 * calls * OWD_B  # the boundary windows' BpOsdDecoder
    assert counters["owd.windows.resident"] == 4 * calls
    for cause, n in (("owd_shots_h2d", 1), ("owd_predictions_d2h", 1), ("owd_corr_d2h", 1),
                     ("owd_select", 2)):
        assert counters["sync." + cause] == n * calls
        assert sum(s.name == "sync." + cause for s in spans) == n * calls


def test_owd_host_loop_spans():
    _, (spans, counters), _, _ = _owd(1, True, "host")
    assert [s.name for s in spans if s.parent == 0] == (
        ["owd.h2d"] + ["owd.window"] * 4 + ["owd.predict", "owd.d2h"])
    assert counters["owd.windows.host"] == counters["owd.windows.resident"] == 4
    assert "owd.windows.device" not in counters
    assert not any(s.name.startswith(("owd.scan", "owd.bookkeeping", "sync.owd_select"))
                   for s in spans)


@pytest.mark.parametrize("path,narrowed,resident", [
    ("device", 2, 4), ("host", 4, 4), ("numpy", 4, 0)])
def test_owd_narrowed_windows_count(path, narrowed, resident):
    """``owd.windows.narrowed`` counts a call's loop windows whose decoder
    takes fewer columns than the DEM has: both boundary windows beside the
    device windows, every window with the scan off and every window of the
    numpy loop (window decoders without the device entry), whose windows
    are not resident."""
    from test_torch_owd_phenom import FAMILIES, _decoder, _experiment, _NumpyLoop, _quiet

    _, model, shots = _experiment()
    cls = type("NumpyLoop", (_NumpyLoop, FAMILIES[0]), {}) if path == "numpy" else FAMILIES[0]
    dec = _decoder(model, "device" if path == "numpy" else path, cls)
    _quiet(dec.decode_batch, shots.copy())  # builds the loop windows' decoders
    pf.drain()
    pf.record(True)
    try:
        for _ in range(2):
            _quiet(dec.decode_batch, shots.copy())
    finally:
        pf.record(False)
    counters = pf.drain().counters
    assert counters.get("owd.windows.narrowed", 0) == 2 * narrowed
    assert counters.get("owd.windows.resident", 0) == 2 * resident
    assert counters["owd.windows.host"] == 2 * (4 if path != "device" else 2)


def test_owd_packed_results_come_back_in_one_copy():
    """Packed predictions and corrections cross in one copy
    (``sync.owd_results_d2h``), and ``owd.d2h_bytes`` counts both."""
    from test_torch_owd_phenom import _decoder, _experiment, _quiet

    _, model, shots = _experiment()
    dec = _decoder(model, "device")
    packed = np.packbits(shots, axis=1, bitorder="little")
    kw = dict(bit_packed_shots=True, bit_packed_predictions=True, return_corrections=True)
    dec.decode_batch(packed.copy(), **kw)  # builds the boundary windows' decoders
    pf.drain()
    pf.record(True)
    try:
        pred, corr = _quiet(dec.decode_batch, packed.copy(), **kw)
    finally:
        pf.record(False)
    spans, counters = pf.drain()
    d2h = [i for i, s in enumerate(spans) if s.name == "owd.d2h"]
    assert len(d2h) == 1
    assert [s.name for s in spans if s.parent == d2h[0]] == ["sync.owd_results_d2h"]
    assert counters["owd.d2h_bytes"] == pred.nbytes + corr.nbytes == OWD_B * (1 + corr.shape[1])
    assert pred.flags.c_contiguous and corr.flags.c_contiguous


def test_owd_recorder_off_records_nothing_and_syncs_alike():
    """Off, the OWD's sites are the shared null span and nothing is kept; on
    or off, the call reaches the same host syncs and returns the same
    arrays."""
    off, rec_off, sites_off, _ = _owd(1, False)
    on, rec_on, sites_on, _ = _owd(1, True)
    assert rec_off == pf.Recording([], {})
    assert sites_off == sites_on and sites_on.count("owd_select") == 2
    assert sum(v for k, v in rec_on.counters.items() if k.startswith("sync.owd")) == sum(
        c.startswith("owd") for c in sites_on)
    for a, b in zip(off[0], on[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pf.span("owd.scan", lanes=3) is pf.NULL_SPAN
    assert pf.sync("owd_select") is pf.NULL_SPAN


# ---------------------------------------------------------------------------
# The device Monte-Carlo's spans and counters (surface d=5 at p = 0.05, 512
# shots x 2 rounds a call; a bucket of 256 lanes, or one of 16 that the
# phase-1 failures overflow)

MC_ROUNDS = 2


def _mc(calls: int, on: bool, bucket: int = None):
    """``calls`` calls of a small device Monte-Carlo with the recorder on or
    off: the counters pulled each call, the recording, the sync sites
    reached and the step."""
    code = surface_code(5, compute_logicals=True)
    mc = device_mc.DeviceMonteCarlo(
        code.hx, 0.05, seed=2**31 + 5, device="cpu", logicals=code.lx, batch_size=512,
        rounds_per_call=MC_ROUNDS, bucket_fraction=2)
    if bucket is not None:
        mc._step.K = bucket
    sites, pulled = [], []
    plain = pf.sync

    def counted(cause):
        sites.append(cause)
        return plain(cause)

    pf.record(on)
    try:
        device_mc.sync = counted
        for _ in range(calls):
            mc.run(int(mc.counters[0]) + mc.runs_per_call)
            pulled.append(mc.last_counters.copy())
    finally:
        pf.record(False)
        device_mc.sync = plain
    return pulled, pf.drain(), sites, mc._step


@pytest.mark.parametrize("bucket", [None, 16], ids=["bucket_holds", "bucket_overflows"])
def test_mc_span_tree_and_counters_of_a_call(bucket):
    """One ``mc.run`` root a call over ``rounds_per_call`` ``mc.round``
    spans and one ``sync.mc_counters``; the ``mc.*`` counters equal the
    counter vectors the calls pulled."""
    calls = 2
    pulled, (spans, counters), sites, step = _mc(calls, True, bucket)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["mc.run"] * calls
    for i in roots:
        assert [s.name for s in spans if s.parent == i] == (
            ["mc.round"] * MC_ROUNDS + ["sync.mc_counters"])
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and s.call == p.call
    # inside a round only the post-processor's own spans
    rounds = [i for i, s in enumerate(spans) if s.name == "mc.round"]
    assert {spans[j].name for j in range(len(spans)) if spans[j].parent in rounds} == {"osd"}
    total = np.sum(pulled, axis=0)
    assert counters["mc.calls"] == calls and counters["mc.shots"] == total[0] == 1024 * calls
    assert counters["mc.rounds"] == MC_ROUNDS * calls
    assert counters["mc.lanes.bucket"] == step.K * MC_ROUNDS * calls
    assert counters["mc.lanes.osd"] == total[4] > 0
    assert counters["mc.bucket_overflow"] == total[5]
    assert (total[5] > 0) == (bucket is not None)
    assert counters["sync.mc_counters"] == calls and sites == ["mc_counters"] * calls
    assert sum(v for k, v in counters.items() if k.startswith("sync.")) == calls


def test_mc_recorder_off_records_nothing_and_syncs_alike():
    """Off, the Monte-Carlo's sites are the shared null span and nothing is
    kept; on or off, a call reaches the same host sync and pulls the same
    counters."""
    off, rec_off, sites_off, _ = _mc(1, False)
    on, rec_on, sites_on, _ = _mc(1, True)
    assert rec_off == pf.Recording([], {})
    assert sites_off == sites_on == ["mc_counters"]
    assert rec_on.counters["sync.mc_counters"] == 1
    assert off[0].tolist() == on[0].tolist()
    assert pf.span("mc.run") is pf.NULL_SPAN and pf.span("mc.round") is pf.NULL_SPAN
    assert pf.sync("mc_counters") is pf.NULL_SPAN


# ---------------------------------------------------------------------------
# The sliding-window decoder's spans and counters (surface d=5 histories of
# 12 rounds, windows of 4 sliding by 2: 5 windows a call; 64 shots)

WIN_ROUNDS, WIN_WINDOWS = 12, 5


def _window(calls: int, on: bool, analog: bool):
    """``calls`` calls of a small window decoder with the recorder on or
    off: the results, the recording, the sync sites reached and the lanes
    each window's ``sync.window_select`` selected."""
    from test_torch_window_reference import _history, _hx, P, W

    syn, ana = _history(WIN_ROUNDS)
    dec = window.make_window_decoder(_hx(), W, P, P, device="cpu",
                                     sigma=get_sigma_from_syndr_er(P) if analog else None)
    sites, selected = [], []
    plain_sync, plain_post = pf.sync, window._postprocess

    def counted(cause):
        sites.append(cause)
        return plain_sync(cause)

    def post(fn, s, bp, cause="window_select"):
        selected.append(int((~bp.converged).sum()))
        return plain_post(fn, s, bp, cause)

    outs = []
    pf.record(on)
    try:
        window.sync, window._postprocess = counted, post
        for _ in range(calls):
            outs.append(dec(syn, ana if analog else None))
    finally:
        pf.record(False)
        window.sync, window._postprocess = plain_sync, plain_post
    return outs, pf.drain(), sites, selected


@pytest.mark.parametrize("analog", [False, True], ids=["binary", "analog"])
def test_window_span_tree_and_counters_of_a_call(analog):
    """One ``window.decode`` root a call over a ``window.step`` a window,
    each holding its lane selection's sync and, where lanes are left, the
    post-processor's span; ``window.lanes.post`` counts the lanes each
    selection took."""
    from test_torch_window_reference import B

    calls = 2
    _, (spans, counters), sites, selected = _window(calls, True, analog)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["window.decode"] * calls
    assert all(spans[i].attrs == {"lanes": B} for i in roots)
    for i in roots:
        assert [s.name for s in spans if s.parent == i] == ["window.step"] * WIN_WINDOWS
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and s.call == p.call
    steps = [i for i, s in enumerate(spans) if s.name == "window.step"]
    for i, lanes in zip(steps, selected):
        assert spans[i].attrs == {"lanes": B}
        assert [s.name for s in spans if s.parent == i] == ["sync.window_select"] + ["osd"] * (
            lanes > 0)
    assert len(selected) == calls * WIN_WINDOWS and sum(selected) > 0
    assert counters["window.shots"] == calls * B
    assert counters["window.windows"] == calls * WIN_WINDOWS
    assert counters.get("window.windows.analog", 0) == (calls * WIN_WINDOWS if analog else 0)
    assert counters["window.lanes.post"] == sum(selected) == counters["lanes.osd"]
    assert counters["sync.window_select"] == calls * WIN_WINDOWS
    assert sites == ["window_select"] * (calls * WIN_WINDOWS)
    assert {k for k in counters if k.startswith("sync.")} == {"sync.window_select"}


def test_window_recorder_off_records_nothing_and_syncs_alike():
    off, rec_off, sites_off, _ = _window(1, False, True)
    on, _, sites_on, _ = _window(1, True, True)
    assert rec_off == pf.Recording([], {})
    assert sites_off == sites_on == ["window_select"] * WIN_WINDOWS
    assert torch.equal(off[0].correction, on[0].correction)
    assert torch.equal(off[0].bp_iterations, on[0].bp_iterations)
    assert pf.span("window.decode", lanes=3) is pf.NULL_SPAN
    assert pf.span("window.step") is pf.NULL_SPAN


@pytest.mark.parametrize("analog", [False, True], ids=["binary", "analog"])
def test_device_qss_opens_window_steps_without_a_decoders_root(analog):
    """A ``DeviceQss`` call runs the window engine: its windows open
    ``window.step`` and count ``window.windows``; it opens no
    ``window.decode`` and counts no shots of the window decoder's; its one
    sync a window stays ``sync.window_select``, and on the CPU no kernel is
    launched."""
    from ldpc_tpu_torch.monte_carlo_simulation import DeviceQss

    code = surface_code(5, compute_logicals=True)
    qss = DeviceQss(code.hx, 0.02, 0.02, code.lx, repetitions=4, rounds=8, batch_size=64,
                    analog_tg=analog, device="cpu", seed=2**31 + 26)
    pf.record(True)
    try:
        qss.run(64)
    finally:
        pf.record(False)
    spans, counters = pf.drain()
    windows = qss._step.NW
    assert qss.calls == 1 and windows == 3
    assert [s.name for s in spans if s.parent < 0] == ["window.step"] * windows
    assert not any(s.name == "window.decode" for s in spans)
    assert "window.shots" not in counters
    assert counters["window.windows"] == windows
    assert counters.get("window.windows.analog", 0) == (windows if analog else 0)
    assert {k for k in counters if k.startswith("sync.")} == {"sync.window_select"}
    assert counters["sync.window_select"] == windows
    assert not any(k.startswith("launch.") for k in counters)


def test_owd_counts_none_of_the_window_engines():
    """The OWD's device windows share ``window._postprocess``: they count
    their OSD-0 lanes as ``owd.lanes.osd0`` alone, as before."""
    _, (spans, counters), _, work = _owd(1, True)
    assert counters["owd.lanes.osd0"] == work[1]["osd_lanes"] + work[2]["osd_lanes"] > 0
    assert not any(k.startswith("window.") for k in counters)
    assert not any(s.name.startswith("window.") for s in spans)
