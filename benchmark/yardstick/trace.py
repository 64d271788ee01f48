"""Reading a ``torch.profiler`` trace of a slice of calls.

``busy_us`` and ``device_events`` are frozen copies of
``tools/profile_torch.py``'s: device time is the union of the kernel,
memcpy and memset intervals of the profiler's chrome trace. The idle
gaps between them are named by the innermost torch operator (or, outside
every operator, the harness's call span) that was running on the host at
the gap's middle.
"""

import json
import os
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")  # torch operators and the harness's call spans
TOP = 10  # entries of each breakdown list


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def chrome_trace(prof) -> dict:
    """The profiled slice's chrome trace (written to a temporary file and
    removed): ``traceEvents`` and, where the profiler writes it,
    ``baseTimeNanoseconds``, which puts an event's ``ts`` on the clock of
    ``time.time_ns()`` (``yardstick/spans.py``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace if isinstance(trace, dict) else {"traceEvents": trace}


def events(prof):
    """``(device events, host events)`` of the profiled slice, from its
    chrome trace."""
    xs = [e for e in chrome_trace(prof)["traceEvents"] if e.get("ph") == "X"]
    return ([e for e in xs if e.get("cat") in DEVICE_CATS],
            [e for e in xs if e.get("cat") in HOST_CATS])


def device_ops(device_events):
    """Device seconds by operation name, the largest first."""
    by = {}
    for e in device_events:
        name = e["name"][:96]
        by[name] = by.get(name, 0.0) + e["dur"] / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def idle_gaps(device_events, host_events):
    """Idle device seconds between device operations, summed by the innermost
    host operation running at each gap's middle, the largest first."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events)
    gaps, end = [], None
    for a, b in iv:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    if not gaps:
        return []
    starts = np.array([e["ts"] for e in host_events], dtype=np.float64)
    ends = starts + np.array([e["dur"] for e in host_events], dtype=np.float64)
    by = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = host_events[inside[np.argmax(starts[inside])]]["name"][:96] if inside.size else "(no host op)"
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]
