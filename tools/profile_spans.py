"""Read the decode path's spans and counters (``ldpc_tpu_torch.utils``'s
recorder) on one NVIDIA GPU.

Usage, from the repository root:

    python tools/profile_spans.py [--seed N] [--calls 16] [--batch 4096]
        [--device cuda] [--out chiprun_out/profile_spans.json]

The workload is the configuration of the benchmark's toric cell
(``benchmark/configs/toric20_bsc.json``): ``BpOsdDecoder`` on the
[[800,2,20]] toric code's X checks, bit flips at p=0.05, min-sum with
alpha 0.625, at most 10 iterations, OSD-CS of order 5, float32; each call
decodes ``--batch`` syndromes drawn from ``--seed``. After a few warm
calls, ``--calls`` calls run with the recorder on under a device-only
profile (CUPTI). The result, written to ``--out`` and printed on two lines:
the span table (``span_table``: per span name its spans, host, self and
device-idle ms a call), the counters a call, and five readings:

- ``post.span_ms``: host ms a call in the ``osd`` span;
- ``post.sweep_idle_share``: inside the ``osd.sweep`` spans, the share of
  their wall in which the device ran no kernel, copy or memset;
- ``decoders.sync_wait_ms``: host ms a call in ``sync.*`` spans;
- ``decoders.program_syncs``: the ``sync.*`` counters a call;
- ``device.idle_between_calls_share``: of the slice's idle device time, the
  share outside every ``decode_batch`` span.

Device events move onto the spans' clock by ``ts + baseTimeNanoseconds /
1e3``. The trace's device timeline can stray from its host timeline by
milliseconds, so each call's device events are then moved by the least
shift that puts none before its launch and none launched in the call after
the call's end (its last sync waited for them): ``anchor`` in the result
gives the shifts. Where no shift does both, the two idle readings are None.
With ``--device cpu`` there are no device events, and they are None too.
"""

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ldpc_tpu_torch  # noqa: E402
from ldpc_tpu_torch.codes import toric_code  # noqa: E402
from ldpc_tpu_torch.utils import profiling as pf  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")  # CUPTI's records of the launches
ERROR_RATE = 0.05
WARM_CALLS = 4
POOL = 4  # distinct batches, cycled


def decoder_and_pool(batch: int, seed: int, device: str):
    hx = toric_code(20).hx.toarray().astype(np.uint8)
    dec = ldpc_tpu_torch.BpOsdDecoder(
        hx, error_rate=ERROR_RATE, max_iter=10, bp_method="minimum_sum",
        ms_scaling_factor=0.625, schedule="parallel", osd_method="osd_cs", osd_order=5,
        dtype="float32", device=device)
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(POOL):
        err = (rng.random((batch, hx.shape[1])) < ERROR_RATE).astype(np.float32)
        pool.append((err @ hx.T.astype(np.float32) % 2).astype(np.uint8))
    return dec, pool


def chrome_trace(prof) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def device_busy(spans, trace):
    """The device's busy intervals ``(start, end)`` in microseconds on the
    spans' clock, each call's moved as the module's docstring says, and a
    report of the shifts. The intervals are None where the trace has no
    device event, the recording no ``decode_batch`` span, or some call no
    shift that holds."""
    evs = [e for e in (trace or {}).get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    roots = sorted((s for s in spans if s.name == "decode_batch"), key=lambda s: s.start_ns)
    report = {"device_events": len(dev), "calls": len(roots)}
    if not dev or not roots:
        return None, report
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    launch_us = {e["args"]["correlation"]: e["ts"] + base_us for e in evs
                 if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
    starts = [r.start_ns / 1e3 for r in roots]
    lo = [-np.inf] * len(roots)  # least shift: no operation before its launch
    hi = [np.inf] * len(roots)  # most: none launched in the call ends after it
    owner, late, lead = [], [], []
    i = 0  # an event without a launch record goes with the one before it
    for e in dev:
        a = e["ts"] + base_us
        h = launch_us.get(e.get("args", {}).get("correlation"))
        if h is not None:
            i = max(0, bisect.bisect_right(starts, h) - 1)
            lo[i] = max(lo[i], h - a)
            lead.append(a - h)
            if h <= roots[i].end_ns / 1e3:
                hi[i] = min(hi[i], roots[i].end_ns / 1e3 - (a + e["dur"]))
                late.append(a + e["dur"] - roots[i].end_ns / 1e3)
        owner.append(i)
    shift = [min(max(0.0, a), b) for a, b in zip(lo, hi)]
    bad = sum(a > b for a, b in zip(lo, hi))
    report.update({
        "launch_to_start_min_us": min(lead, default=None),
        "end_past_call_max_us": max(late, default=None),
        "calls_moved": sum(s != 0 for s in shift),
        "shift_us": [min(shift), max(shift)],
        "calls_without_shift": bad,
    })
    if bad:
        return None, report
    return [(e["ts"] + base_us + shift[i], e["ts"] + base_us + e["dur"] + shift[i])
            for e, i in zip(dev, owner)], report


def readings(rec, trace, calls: int, slice_ns) -> dict:
    """The span table, the counters a call and the five readings of the
    recording ``rec`` of ``calls`` calls, with the profile's Chrome
    ``trace`` (or None) over the slice ``slice_ns`` (``time.time_ns()``
    at its start and end)."""
    spans, counters = rec
    busy, anchor = device_busy(spans, trace)
    table = pf.span_table(spans, calls, busy)
    syncs = [v for k, v in counters.items() if k.startswith("sync.")]
    waits = [r["ms"] for k, r in table.items() if k.startswith("sync.")]
    out = {
        "post.span_ms": table.get("osd", {}).get("ms"),
        "post.sweep_idle_share": None,
        "decoders.sync_wait_ms": sum(waits) if waits else None,
        "decoders.program_syncs": sum(syncs) / calls if syncs else None,
        "device.idle_between_calls_share": None,
        "anchor": anchor,
        "program": {"spans": table, "counters": {k: v / calls for k, v in sorted(counters.items())}},
    }
    if busy is None:
        return out
    sweep_ms = sum(s.end_ns - s.start_ns for s in spans if s.name == "osd.sweep") / 1e6
    if sweep_ms:
        out["post.sweep_idle_share"] = table["osd.sweep"]["idle_ms"] * calls / sweep_ms
    whole = pf.Span("slice", slice_ns[0], slice_ns[1], -1, 0, {})
    idle = pf.span_table([whole], 1, busy)["slice"]["idle_ms"]
    if idle:
        out["device.idle_between_calls_share"] = 1 - table["decode_batch"]["idle_ms"] * calls / idle
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2**31 + 17)
    parser.add_argument("--calls", type=int, default=16)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="chiprun_out/profile_spans.json")
    args = parser.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("profile_spans: no CUDA device", file=sys.stderr)
        return 1
    dec, pool = decoder_and_pool(args.batch, args.seed, args.device)
    for i in range(WARM_CALLS):
        dec.decode_batch(pool[i % POOL])

    fence = torch.cuda.synchronize if cuda else (lambda: None)
    fence()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        pf.record(True)
        t0, ns0 = time.perf_counter(), time.time_ns()
        for i in range(args.calls):
            dec.decode_batch(pool[i % POOL])
        fence()
        wall, ns1 = time.perf_counter() - t0, time.time_ns()
        pf.record(False)
    rec = pf.drain()
    result = {"card": card() if cuda else "cpu", "torch": torch.__version__, "seed": args.seed,
              "calls": args.calls, "batch": args.batch,
              "shots_per_s": args.calls * args.batch / wall,
              **readings(rec, chrome_trace(prof), args.calls, (ns0, ns1))}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "program"}), flush=True)
    print(json.dumps(result["program"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
