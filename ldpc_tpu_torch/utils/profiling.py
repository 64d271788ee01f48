"""Tracing and per-stage profiling hooks (port of
``ldpc_tpu.utils.profiling``).

The questions worth asking are device-side — which kernel dominates,
whether the host boundary is the bottleneck — so the hooks wrap the
PyTorch profiler:

- :func:`trace` — capture a Chrome trace of a code region (CPU ops and,
  with a card, its kernels, copies and memsets), viewable in Perfetto or
  ``chrome://tracing``.
- :func:`annotate` — name a region so it is attributable in the trace
  (``record_function``, and an NVTX range on CUDA).
- :class:`StageTimer` — host-side per-stage wall-clock breakdown, fenced
  with ``torch.cuda.synchronize`` so queued device work is charged to the
  stage that launched it.
- :func:`profile_decode` — one-call breakdown of a decoder's
  ``decode_batch`` path.
- The recorder — spans and counters that the decode path keeps in memory
  while :func:`record` has turned it on: :func:`span` (a named region on
  the host's ``time.time_ns()`` clock), :func:`count` (a named total),
  :func:`sync` (a host sync by cause, a span and a count) and
  :func:`drain` (take and clear what was kept). Off by default, and then a
  span or count site costs one flag check. :func:`tally` keeps a region's
  counts apart, on or off: what a captured CUDA graph launches, counted
  again on each replay.

The recorder is the port's one counter: besides the decoders' ``lanes.*``,
``osd.*``, ``owd.*`` (``owd.shots``; ``owd.windows.host``, ``.device``,
``.resident`` and ``.narrowed``, the loop windows whose decoder takes fewer
columns than the DEM has; ``owd.lanes.osd0``; ``owd.d2h_bytes``), the
device Monte-Carlo's ``mc.*`` (``mc.calls``, ``mc.shots`` and
``mc.rounds`` under the spans ``mc.run`` and ``mc.round``;
``mc.lanes.bucket``, ``mc.lanes.osd`` and ``mc.bucket_overflow``, read from
the counters its ``sync.mc_counters`` pulls; on a card ``mc.graph.captures``
and ``mc.graph.replays``), the window engine's ``window.*``
(``parallel/window.py``: ``window.shots`` under the span ``window.decode``,
one a ``make_window_decoder`` call; ``window.windows`` and
``window.windows.analog``, the windows decoded and those on a per-lane
prior, under the span ``window.step``, which ``DeviceQss`` opens too;
``window.lanes.post``, the lanes BP left unconverged that OSD-0 or LSD-0
took, from the count that ``sync.window_select`` brings to the host) and
``sync.<cause>`` counts, each hand-written
kernel's wrapper (``ops.<module>.<kernel>_cuda``; the OSD-w sweep's is
``osd_cuda.sweep_cuda``) counts every launch once under ``launch.<kernel>``
and once under ``launch.<kernel>.<split>`` for each of its splits. K2′ and
K4′ in their device variant launch once a chunk of lanes. A launch that a
CUDA graph holds is counted on each replay, from the :func:`tally` of its
capture.

=================  =====  ========  ==========================================
kernel             kind   module    splits
=================  =====  ========  ==========================================
bp_parallel        K1′    bp_cuda   shared, device (state); float32, float64;
                                    lane_prior (a ``(B, n)`` prior)
osd0               K2′    gf2_cuda  warp, block, device (variant)
rref_export        K3′    gf2_cuda  warp, block, device
masked_solve       K4′    gf2_cuda  warp, block, device
masked_export      K5′    gf2_cuda  warp, block, device
bp_serial          K6′    bp_fold   shared, device (state)
bp_soft_info       K7′    bp_fold   shared, device
bp_parallel_exact  K8′    bp_fold   shared, device
mbp                K9′    mbp_cuda  float32, float64
osd_sweep          OSD-w  osd_cuda  shared, device (variant)
flip               flip   flip      none
=================  =====  ========  ==========================================
"""

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed region into ``log_dir``
    (one ``trace_<pid>_<ns>.json`` Chrome trace a region). CPU activity
    always; CUDA activity where a card is present. Yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


@contextlib.contextmanager
def annotate(name: str):
    """Name a region for the trace (``record_function``; with a card also
    an NVTX range). Usable as a context manager or a decorator."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _fence(device=None) -> None:
    """Wait for queued CUDA work (on ``device``, else the current card);
    nothing to wait for if CUDA was never initialised (CPU runs)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


class StageTimer:
    """Per-stage wall-clock breakdown with device fencing.

    >>> t = StageTimer()
    >>> with t.stage("bp"):
    ...     out = bp_fn(syndromes, llr)   # launched asynchronously
    >>> t.report()                        # {'bp': 0.0123, ...}

    Each ``stage`` exit synchronizes ``device`` (the current card by
    default) when CUDA is in use, so queued device work is charged to the
    stage that launched it; on the CPU nothing extra happens.
    """

    def __init__(self, device=None):
        self.device = device
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence_output: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence_output:
                _fence(self.device)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def fence(self, value):
        """Wait for ``value`` (a tensor's device, else this timer's) inside a
        stage for exact device timing; returns ``value``."""
        if isinstance(value, torch.Tensor):
            if value.device.type == "cuda":
                torch.cuda.synchronize(value.device)
        else:
            _fence(self.device)
        return value

    def report(self) -> Dict[str, float]:
        return dict(self.times)

    def pretty(self) -> str:
        total = sum(self.times.values()) or 1.0
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:<24s} {dt * 1e3:10.2f} ms  {100 * dt / total:5.1f}%"
            f"  (x{self.counts[name]})"
            for name, dt in rows
        )


def profile_decode(
    decoder,
    syndromes,
    *,
    repeats: int = 3,
    log_dir: Optional[str] = None,
) -> Dict[str, float]:
    """Per-stage breakdown of a decoder's ``decode_batch`` path.

    Stages: ``compile`` (the first call, which includes building the
    kernels on first use), ``decode`` (median of ``repeats`` steady-state
    calls, host-device transfers included). With ``log_dir`` set, the
    steady-state calls also write a trace there (:func:`trace`).
    """
    timer = StageTimer()
    with timer.stage("compile"):
        timer.fence(decoder.decode_batch(syndromes))

    ctx = trace(log_dir) if log_dir else contextlib.nullcontext()
    laps = []
    with ctx:
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            with annotate("decode_batch"):
                decoder.decode_batch(syndromes)
            _fence()
            laps.append(time.perf_counter() - t0)
    laps.sort()
    med = laps[len(laps) // 2]
    report = timer.report()
    report["decode"] = med
    report["syndromes_per_sec"] = float(np.shape(syndromes)[0]) / med
    return report


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------
#
# ``time.time_ns()`` is the clock of the profiler's Chrome trace: an event's
# ``ts`` plus the trace's ``baseTimeNanoseconds / 1e3`` is in the same
# microseconds as ``start_ns / 1e3``, so the spans sit on a trace's own
# timeline without a calibration run. On an H100 the trace's host records
# (CUPTI's runtime calls) fall inside their spans to about 10 us; its device
# timeline can stray from the host's by a millisecond or more.


class Span(NamedTuple):
    """One recorded span. ``start_ns`` and ``end_ns`` are ``time.time_ns()``
    readings; ``parent`` is the index of the enclosing span in the same
    recording (-1 for a root); ``call`` numbers the root spans of the
    recording, and a span carries its root's; ``attrs`` holds small integers
    (``lanes``, ``chunk``)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    attrs: Dict[str, int]


class Recording(NamedTuple):
    """What :func:`drain` takes: the spans in the order they opened, and
    the counters' totals."""

    spans: List[Span]
    counters: Dict[str, int]


class _NullSpan:
    """The span a site gets while the recorder is off: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

_on = False
_tallies = 0  # tallies open, in every thread
_spans: list = []  # [name, start_ns, end_ns, parent, call, attrs] a span
_counters: Dict[str, int] = {}
_calls = itertools.count()
_lock = threading.Lock()
_open = threading.local()  # .stack: indices of a thread's open spans; .tally: its tally


def record(on: bool = True) -> None:
    """Turn the recorder on (or off). What it kept stays until :func:`drain`."""
    global _on
    _on = bool(on)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("_name", "_attrs", "_rec", "_ann")

    def __init__(self, name: str, attrs: Dict[str, int]):
        self._name, self._attrs = name, attrs

    def __enter__(self):
        self._ann = annotate(self._name)
        self._ann.__enter__()
        stack = _stack()
        with _lock:
            parent = stack[-1] if stack else -1
            call = _spans[parent][4] if parent >= 0 else next(_calls)
            self._rec = [self._name, time.time_ns(), 0, parent, call, self._attrs]
            stack.append(len(_spans))
            _spans.append(self._rec)
        return None

    def __exit__(self, *exc):
        self._rec[2] = time.time_ns()
        stack = _stack()
        if stack:
            stack.pop()
        return self._ann.__exit__(*exc)


def span(name: str, lanes: Optional[int] = None, chunk: Optional[int] = None):
    """A context manager that records the enclosed region as the span
    ``name`` while the recorder is on; it also enters :func:`annotate`, so a
    trace taken meanwhile shows the region under that name. ``lanes`` and
    ``chunk`` are kept as its attributes. Off, it returns
    :data:`NULL_SPAN`: no clock read, no annotation, nothing allocated."""
    if not _on or _tallying():
        return NULL_SPAN
    attrs = {}
    if lanes is not None:
        attrs["lanes"] = int(lanes)
    if chunk is not None:
        attrs["chunk"] = int(chunk)
    return _Span(name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` while the recorder is on. ``k``
    must already be on the host: a count adds no sync. The module's
    docstring lists the kernels' launch counters. Inside :func:`tally` the
    count goes to the tally instead, the recorder on or off."""
    if _on or _tallies:
        kept = getattr(_open, "tally", None)
        if kept is not None:
            kept[name] = kept.get(name, 0) + int(k)
        elif _on:
            with _lock:
                _counters[name] = _counters.get(name, 0) + int(k)


def _tallying() -> bool:
    return getattr(_open, "tally", None) is not None


@contextlib.contextmanager
def tally():
    """Keep this thread's counts in the enclosed region in the dict it
    yields, whether the recorder is on or off, and none of them in the
    recorder's totals; the region's spans and syncs are not recorded. For a
    region that is captured into a CUDA graph, not run: add the tally with
    :func:`count` on each replay, and the replays count what the eager
    region would have."""
    global _tallies
    kept: Dict[str, int] = {}
    outer = getattr(_open, "tally", None)
    with _lock:
        _tallies += 1
    _open.tally = kept
    try:
        yield kept
    finally:
        _open.tally = outer
        with _lock:
            _tallies -= 1


def sync(cause: str):
    """The span ``sync.<cause>``, which also counts ``sync.<cause>``: put
    the operation that makes the host wait for the device inside it, and
    the span's length is that wait."""
    if not _on or _tallying():
        return NULL_SPAN
    name = "sync." + cause
    count(name)
    return _Span(name, {})


def drain() -> Recording:
    """Take what the recorder kept and clear it; call ids start again at 0.
    Call it with no span open."""
    global _calls
    with _lock:
        spans = [Span(*rec) for rec in _spans]
        counters = dict(_counters)
        _spans.clear()
        _counters.clear()
        _calls = itertools.count()
    _open.stack = []
    return Recording(spans, counters)

