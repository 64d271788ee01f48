"""One run of one cell: set-up, a closed loop for the window, the check.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs[].file``) and its
traffic mix (``benchmark/traffic/<traffic>.json``), the mix names its
driver (``benchmark/drivers/<driver>.py``), the cell's limits are in
``benchmark/limits/<cell>.json``, and each per-layer metric is read by
``benchmark/metrics/<metric>.py``.

A run:

1. builds the cell's traffic driver (the configuration's code, the program's decoder and
   the inputs drawn from the seed) and warms it with its own calls; then
   collects and freezes Python's garbage collector's survivors, so that
   no collection in the window walks set-up's objects; ``setup_s`` runs
   from the process's start to here;
2. calls it back to back for ``seconds``: ``shots_per_s`` is every
   shot returned over the whole window, ``latency_p95_ms`` the 95th
   percentile of every call's wall; a seeded reservoir keeps a copy of
   ``check_calls`` of the calls for the check, and no call's output is
   held past the call that follows it;
3. with ``trace``, after the window: ``trace_calls`` calls under a device-only
   profile (CUPTI; the per-layer metrics, with the window's mean call wall
   for the idle share, ``busy_s``, the device operations of the
   breakdown, and the slice's own rate beside the window's), ``gap_calls`` more under a host and device profile (only to
   name the idle gaps of the breakdown), the host syncs of
   ``sync_calls`` more, and last ``span_calls`` more with the program's
   recorder on (``program.record``) under a device-only profile: its spans
   and counters, with that slice's device events moved onto the spans'
   clock (``yardstick/spans.py``), for the per-layer metrics that read them
   and the result's ``program`` key (the span table and the counters a
   call);
4. reads the device's peak memory, drops the program's state and judges
   the kept calls against the plain reference (``judge.py``).
"""

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import judge, program
from benchmark.yardstick import spans as sp
from benchmark.yardstick import trace as tr
from benchmark.yardstick.syncs import count_syncs

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_tpu")  # top-level module names


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Reservoir:
    """``k`` items kept uniformly at random from a stream, by a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, make, *args) -> None:
        """Offer the next item, ``make(*args)``, which is called only when
        the item is kept."""
        if len(self.items) < self.k:
            self.items.append(make(*args))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = make(*args)
        self.seen += 1


class Cell:
    """A cell's entry, configuration, traffic, limits and driver, by name."""

    def __init__(self, workload: str, root: Path = ROOT, traffic: dict = None):
        self.spec = load_json(root / "BENCHMARK.json")
        self.entry = next(w for w in self.spec["workloads"] if w["name"] == workload)
        conf = next(c for c in self.spec["configs"] if c["name"] == self.entry["config"])
        self.cfg = load_json(root / conf["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{self.entry['traffic']}.json")
        self.traffic.update(traffic or {})
        self.limits = load_json(root / "benchmark" / "limits" / f"{workload}.json")
        self.driver_module = load_module(
            root / "benchmark" / "drivers" / f"{self.traffic['driver']}.py")

    def metrics(self, kind: str) -> list:
        name = self.entry["name"]
        return [m for m in self.spec[kind] if name in m.get("workloads", [name])]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        started: float = None, root: Path = ROOT, traffic: dict = None, driver_hook=None) -> dict:
    """One run; returns the result line's fields, ``checks`` last.
    ``driver_hook(driver)`` may replace parts of the traffic driver (tests)."""
    started = time.perf_counter() if started is None else started
    cell = Cell(workload, root, traffic)
    t = cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = cell.driver_module.Driver(cell.cfg, t, seed, device)
    if driver_hook is not None:
        driver_hook(driver)
    driver.warm()
    _sync(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started

    keep = Reservoir(t["check_calls"], seed)
    walls, shots = [], 0
    i = t["warm_calls"]
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        n, out = driver.call(i)
        b = time.perf_counter()
        walls.append(b - a)
        shots, i = shots + n, i + 1
        keep.offer(driver.keep, out)
        del out
        if b - t0 >= seconds:
            break
    window_s = b - t0
    end_to_end = {"shots_per_s": shots / window_s, "setup_s": setup_s,
                  "latency_p95_ms": float(np.percentile(np.asarray(walls) * 1e3, 95))}

    traced = _trace(driver, t, i, device) if trace else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.judge(keep.items)
    correct, checks = judge.verdict(numbers, cell.limits)

    out = {"correct": correct, "attempted": shots, "failed": driver.failed(numbers)}
    if trace:
        slice_calls = traced.pop("calls")
        recorded = traced.pop("recording")
        ctx = SimpleNamespace(**traced, peak_bytes=peak, sizes=driver.sizes(),
                              window_call_s=window_s / len(walls),
                              work=_lazy(lambda: driver.work(slice_calls)), **recorded)
        metrics = {}
        for m in cell.metrics("per_layer"):
            reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    out["metrics"] = metrics
    out["device"] = _device(device, cell.entry["chips"], peak)
    if trace:
        out["device"].update(busy_s=traced["busy_s"], window_s=traced["slice_s"])
        out["breakdown"] = {"device_ops": tr.device_ops(traced["device_events"]),
                            "idle_gaps": tr.idle_gaps(traced["gap_device_events"],
                                                      traced["gap_host_events"])}
    out["window"] = {"seconds": window_s, "calls": len(walls), "kept_calls": len(keep.items),
                     "shots_per_s_by_tenth": _by_tenth(walls, shots / len(walls))}
    if trace:
        out["window"]["slice"] = {"calls": traced["slice_calls"], "seconds": traced["slice_s"],
                                  "shots_per_s": traced["slice_shots"] / traced["slice_s"]}
        n = recorded["span_calls"]
        out["program"] = {"spans": recorded["span_table"],
                          "counters": {k: v / n for k, v in sorted(recorded["counters"].items())},
                          "anchor": recorded["span_anchor"]}
    out["checks"] = checks
    return out


def _by_tenth(walls: list, shots_per_call: float) -> list:
    """Shots a second in each tenth of the window's calls, in order: how the
    rate moved within the run."""
    k = max(1, len(walls) // 10)
    return [shots_per_call * len(w) / sum(w) for w in (walls[i : i + k] for i in range(0, len(walls), k))]


def _lazy(fn):
    cache = []

    def get():
        if not cache:
            cache.append(fn())
        return cache[0]

    return get


def _trace(driver, t: dict, i: int, device) -> dict:
    """After the window: ``trace_calls`` calls under a device-only profile
    (the per-layer metrics' slice), ``gap_calls`` more under a host and
    device profile (the idle gaps' names alone: recording every host
    operator slows the calls), then the host syncs of ``sync_calls`` more
    (outside both), then the span slice (:func:`_span_slice`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    calls, shots = [], 0
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for j in range(t["trace_calls"]):
            n, out = driver.call(i + j)
            calls.append(i + j)
            shots += n
            del out
        _sync(device)
        slice_s = time.perf_counter() - t0
    i += t["trace_calls"]
    device_events, _ = tr.events(prof)
    del prof
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for j in range(t["gap_calls"]):
            with torch.profiler.record_function("bench.call"):
                driver.call(i + j)
        _sync(device)
    i += t["gap_calls"]
    gap_device_events, gap_host_events = tr.events(prof)
    del prof
    syncs = None
    if cuda:  # torch counts syncs of CUDA devices only
        syncs = count_syncs(lambda: [driver.call(i + j) for j in range(t["sync_calls"])])
    i += t["sync_calls"]
    return {"calls": calls, "device_events": device_events,
            "gap_device_events": gap_device_events, "gap_host_events": gap_host_events,
            "slice_s": slice_s, "slice_calls": t["trace_calls"], "slice_shots": shots,
            "busy_s": tr.busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device_events]) / 1e6,
            "syncs_per_call": None if syncs is None else syncs / t["sync_calls"],
            "recording": _span_slice(driver, t["span_calls"], i, device)}


def _span_slice(driver, calls: int, i: int, device) -> dict:
    """``calls`` calls with the program's recorder on, under a device-only
    profile, read by :func:`recorded`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        program.record(True)
        try:
            ns0 = time.time_ns()
            for j in range(calls):
                driver.call(i + j)
            _sync(device)
            ns1 = time.time_ns()
        finally:
            program.record(False)
    spans, counters = program.drain()
    return recorded(spans, counters, calls, (ns0, ns1), tr.chrome_trace(prof))


def recorded(spans, counters: dict, calls: int, slice_ns: tuple, trace: dict) -> dict:
    """What the span slice gives the per-layer metrics: the program's
    ``spans`` and ``counters`` over ``calls`` calls, the slice's bounds
    ``slice_ns`` on their clock, its device events from the chrome
    ``trace`` moved onto that clock (busy intervals in microseconds, None
    where no call's shift holds), the report of the shifts, and the span
    table."""
    busy, anchor = sp.device_busy(spans, trace)
    return {"spans": spans, "counters": counters, "span_calls": calls,
            "span_slice_ns": slice_ns, "span_device_us": busy, "span_anchor": anchor,
            "span_table": sp.span_table(spans, calls, busy)}


def _device(device, chips: int, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}
