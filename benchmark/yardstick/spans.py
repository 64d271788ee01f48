"""The program's spans read against a device trace of the same calls.

Frozen copies, as plain code, of ``ldpc_tpu_torch/utils/profiling.py``'s
``span_table`` and interval union and of ``tools/profile_spans.py``'s
``device_busy``, kept here so that a change to the program cannot move
the reading. A span is any object with ``name``, ``start_ns``, ``end_ns``
(``time.time_ns()`` readings) and ``parent`` (the index of its enclosing
span in the same recording, -1 for a root), as the program's recorder
drains them. A call's root is the top-level span the call opens, whatever
its name.

``time.time_ns()`` is the clock of the profiler's Chrome trace: an event's
``ts`` plus the trace's ``baseTimeNanoseconds / 1e3`` is in the spans'
microseconds. The trace's device timeline can stray from its host
timeline by milliseconds, so each call's device events are then moved by
the least shift that puts none before its launch and none launched in the
call after the call's end (its last sync waited for them).
"""

import bisect

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # CUPTI's records of the launches


def roots(spans) -> list:
    """The calls' root spans, in the order they opened."""
    return [s for s in spans if s.parent == -1]


def union(intervals):
    """Disjoint sorted union of ``(start, end)`` intervals: its starts, its
    ends and the running total of its lengths (one longer, from 0)."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    starts, ends = np.asarray(starts, np.float64), np.asarray(ends, np.float64)
    return starts, ends, np.concatenate([[0.0], np.cumsum(ends - starts)])


def covered(u, a: float, b: float) -> float:
    """How much of ``[a, b]`` the union ``u`` (of :func:`union`) covers."""
    starts, ends, total = u
    i = int(np.searchsorted(ends, a, side="right"))  # first interval ending after a
    j = int(np.searchsorted(starts, b, side="left"))  # past the last starting before b
    if j <= i:
        return 0.0
    inside = total[j] - total[i]
    inside -= max(0.0, a - starts[i])
    inside -= max(0.0, ends[j - 1] - b)
    return max(0.0, inside)


def idle_us(u, a: float, b: float) -> float:
    """Microseconds of ``[a, b]`` that the busy union ``u`` leaves idle."""
    return b - a - covered(u, a, b)


def span_table(spans, calls: int = 1, device_us=None) -> dict:
    """Per span name over ``calls`` calls: ``spans`` (how many), ``ms`` (host
    wall a call), ``self_ms`` (that wall less the part its child spans
    cover, a call) and, given the device's busy intervals ``device_us`` in
    microseconds on the spans' clock, ``idle_ms``: the time a call inside
    the span in which none of them ran."""
    children = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            children[s.parent] += s.end_ns - s.start_ns
    busy = union(device_us) if device_us is not None else None
    table = {}
    for s, child_ns in zip(spans, children):
        row = table.setdefault(s.name, {"spans": 0, "ms": 0.0, "self_ms": 0.0})
        wall = (s.end_ns - s.start_ns) / 1e6
        row["spans"] += 1
        row["ms"] += wall / calls
        row["self_ms"] += (wall - child_ns / 1e6) / calls
        if busy is not None:
            a, b = s.start_ns / 1e3, s.end_ns / 1e3
            row["idle_ms"] = row.get("idle_ms", 0.0) + idle_us(busy, a, b) / 1e3 / calls
    return table


def device_busy(spans, trace):
    """The device's busy intervals ``(start, end)`` in microseconds on the
    spans' clock, each call's moved as the module's docstring says, and a
    report of the shifts. The intervals are None where the trace has no
    device event, the recording no root span, or some call no shift that
    holds."""
    evs = [e for e in (trace or {}).get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    calls = sorted(roots(spans), key=lambda s: s.start_ns)
    report = {"device_events": len(dev), "calls": len(calls)}
    if not dev or not calls:
        return None, report
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    launch_us = {e["args"]["correlation"]: e["ts"] + base_us for e in evs
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    starts = [r.start_ns / 1e3 for r in calls]
    lo = [-np.inf] * len(calls)  # least shift: no operation before its launch
    hi = [np.inf] * len(calls)  # most: none launched in the call ends after it
    owner, late, lead = [], [], []
    i = 0  # an event without a launch record goes with the one before it
    for e in dev:
        a = e["ts"] + base_us
        h = launch_us.get(e.get("args", {}).get("correlation"))
        if h is not None:
            i = max(0, bisect.bisect_right(starts, h) - 1)
            lo[i] = max(lo[i], h - a)
            lead.append(a - h)
            if h <= calls[i].end_ns / 1e3:
                hi[i] = min(hi[i], calls[i].end_ns / 1e3 - (a + e["dur"]))
                late.append(a + e["dur"] - calls[i].end_ns / 1e3)
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
