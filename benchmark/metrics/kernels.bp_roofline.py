"""K1' (``csrc/bp_parallel.cu``, ``bp_warp_kernel``) over the profiled
slice: the least time the slice's BP needs (``yardstick/work.py``: every
lane once, to its convergence or the cap, as the reference counts it on
the slice's inputs) over K1''s device time there, in percent."""

from benchmark.yardstick import work

KERNEL = "bp_warp_kernel"


def read(ctx):
    events = [e for e in ctx.device_events if KERNEL in e["name"]]
    if not events:
        return None
    w, z = ctx.work(), ctx.sizes
    bytes_moved = work.k1_bytes(z["m"], z["n"], z["dc"], z["dv"], w["bp_lanes"], len(events))
    ops = work.k1_ops(z["nnz"], z["n"], w["bp_lane_iterations"])
    return 100.0 * work.bound_s(bytes_moved, ops) / (sum(e["dur"] for e in events) / 1e6)
