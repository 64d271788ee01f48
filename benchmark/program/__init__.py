"""The system under test, built from a configuration. The files of this
package are the only ones of the benchmark that import ``ldpc_tpu_torch``:
this one builds ``BpOsdDecoder`` and reaches the program's recorder; a
configuration whose entry is another adds ``program/<entry>.py`` beside it."""

import numpy as np


def reference_params(cfg: dict) -> dict:
    """The decoder settings the plain reference takes."""
    d = cfg["decoder"]
    return {"error_rate": cfg["noise"]["error_rate"], "max_iter": d["max_iter"],
            "ms_scaling_factor": d["ms_scaling_factor"], "osd_method": d["osd_method"],
            "osd_order": d["osd_order"]}


def bposd_decoder(cfg: dict, hx: np.ndarray, device):
    import ldpc_tpu_torch

    d = cfg["decoder"]
    return ldpc_tpu_torch.BpOsdDecoder(
        hx, error_rate=float(cfg["noise"]["error_rate"]), max_iter=d["max_iter"],
        bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
        schedule=d["schedule"], osd_method=d["osd_method"], osd_order=d["osd_order"],
        dtype=d["dtype"], device=device)


def record(on: bool) -> None:
    """Turn the program's recorder of spans and counters on (or off)."""
    from ldpc_tpu_torch.utils import profiling

    profiling.record(on)


def drain():
    """What the recorder kept, ``(spans, counters)``, and clear it: each
    span has ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``) and
    ``parent`` (the index of its enclosing span, -1 for a root)."""
    from ldpc_tpu_torch.utils import profiling

    return profiling.drain()
