"""K3' (``csrc/gf2_elim.cu`` ``ldpc_rref_export``: the warp variant
``gf2_warp_export_kernel<false, ...>``, or the block and device variants'
``gf2_block_kernel<false, true, false, ...>``) over the profiled slice: the
least time the export needs on the lanes BP leaves OSD-CS (each lane's
columns to its last pivot and its full pivot rows, as the reference's
elimination counts them on the slice's inputs) over K3''s device time
there, in percent."""

from benchmark.yardstick import work

NAMES = ("gf2_warp_export_kernel<false", "gf2_block_kernel<false, true, false")


def read(ctx):
    events = [e for e in ctx.device_events if any(k in e["name"] for k in NAMES)]
    if not events:
        return None
    o, z = ctx.work()["osd"], ctx.sizes
    bytes_moved = work.export_bytes(z["m"], z["n"], o["lanes"], o["last_steps"], len(events))
    ops = work.gf2_ops(z["m"], o["last_steps"], o["pivots"] * work.row_words(z["n"]))
    return 100.0 * work.bound_s(bytes_moved, ops) / (sum(e["dur"] for e in events) / 1e6)
