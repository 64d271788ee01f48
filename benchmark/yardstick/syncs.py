"""Host syncs of a call: a frozen copy of ``chip_smoke.py``'s ``count_syncs``."""

import warnings

import torch


def count_syncs(fn) -> int:
    """Host syncs of one ``fn()``: the synchronizing CUDA operations torch
    reports in its sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)
