"""K1' (``csrc/bp_parallel.cu``, ``bp_warp_kernel``) over every launch of
the overlapping-window decoder's profiled slice, device and boundary
windows alike: the least time the slice's window BP needs
(``yardstick/owd.py``: each window's lanes to their convergence or the
cap, on the window's own columns, as ``reference/owd.py`` counts them on
the slice's shots) over K1''s device time there, in percent."""

from benchmark.yardstick import owd, work

KERNEL = "bp_warp_kernel"


def read(ctx):
    events = [e for e in ctx.device_events if KERNEL in e["name"]]
    if not events:
        return None
    moved, ops = owd.k1(ctx.work()["windows"])
    return 100.0 * work.bound_s(moved, ops) / (sum(e["dur"] for e in events) / 1e6)
