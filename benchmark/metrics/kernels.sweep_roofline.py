"""The OSD-w candidate sweep (``csrc/osd_sweep.cu``, ``osd_sweep_kernel``)
over the profiled slice: the least time the sweep's bytes need on the lanes
BP leaves OSD-CS (``yardstick/work.py``'s ``sweep_bytes``, from the OSD
lanes and pivots that the reference counts on the slice's inputs) over the
kernel's device time there, in percent. Its row steps (lanes x candidates x
m, one operation each) need less time than its bytes at the cell's sizes."""

from benchmark.yardstick import work

KERNEL = "osd_sweep_kernel"


def read(ctx):
    events = [e for e in ctx.device_events if KERNEL in e["name"]]
    if not events:
        return None
    o, z = ctx.work()["osd"], ctx.sizes
    bytes_moved = work.sweep_bytes(z["m"], z["n"], o["lanes"], o["pivots"])
    return 100.0 * work.bound_s(bytes_moved, 0.0) / (sum(e["dur"] for e in events) / 1e6)
