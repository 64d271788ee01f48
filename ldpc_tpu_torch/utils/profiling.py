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
"""

import contextlib
import os
import time
from typing import Dict, Optional

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
    import numpy as np

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
