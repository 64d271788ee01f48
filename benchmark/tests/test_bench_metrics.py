"""Each per-layer metric's reader on a made-up slice: what it reads, and
nothing where its slice holds nothing to read."""

from pathlib import Path
from types import SimpleNamespace

from benchmark import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(name):
    return harness.load_module(METRICS / f"{name}.py").read


def _ctx(**kw):
    events = [{"name": "bp_warp_kernel<float>", "cat": "kernel", "ts": 0.0, "dur": 300.0},
              {"name": "Memcpy DtoH (Device -> Pageable)", "cat": "gpu_memcpy", "ts": 400.0,
               "dur": 100.0}]
    base = dict(device_events=events, busy_s=400e-6, slice_calls=2, slice_s=4e-3,
                window_call_s=1e-3, peak_bytes=2**30, syncs_per_call=3.0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_idle_share_takes_the_window_wall():
    # 400 us busy over 2 calls of the window's 1 ms, not the slice's 4 ms
    assert abs(_reader("device.idle_share")(_ctx()) - 0.8) < 1e-12
    assert _reader("device.idle_share")(_ctx(device_events=[])) is None


def test_copy_ms_peak_and_syncs():
    assert abs(_reader("decoders.copy_ms")(_ctx()) - 0.05) < 1e-12
    assert _reader("decoders.copy_ms")(_ctx(device_events=[])) is None
    assert _reader("device.peak_mem_gib")(_ctx()) == 1.0
    assert _reader("device.peak_mem_gib")(_ctx(peak_bytes=0)) is None
    assert _reader("decoders.host_syncs")(_ctx()) == 3.0


def test_rooflines_find_nothing_without_their_kernels():
    for name in ("kernels.bp_roofline", "kernels.osdcs_roofline", "kernels.sweep_roofline"):
        assert _reader(name)(_ctx(device_events=[])) is None


def test_sweep_roofline_takes_the_reference_lanes():
    # 4,096 toric d=20 OSD lanes of rank 399: 198,279,168 bytes, 59.1878 us at 3.35 TB/s
    name = "void (anonymous namespace)::osd_sweep_kernel<float, true>(float const*)"
    events = [{"name": name, "cat": "kernel", "ts": 0.0, "dur": 300.0},
              {"name": name, "cat": "kernel", "ts": 900.0, "dur": 591.8781134328358 - 300.0},
              {"name": "gf2_warp_export_kernel<false, 16>", "cat": "kernel", "ts": 400.0,
               "dur": 1000.0}]
    ctx = _ctx(device_events=events, sizes={"m": 400, "n": 800},
               work=lambda: {"osd": {"lanes": 4096, "pivots": 4096 * 399, "last_steps": 0}})
    assert abs(_reader("kernels.sweep_roofline")(ctx) - 10.0) < 1e-9
