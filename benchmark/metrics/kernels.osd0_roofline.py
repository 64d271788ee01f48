"""K2' (``csrc/gf2_elim.cu`` ``ldpc_osd0``: the warp variant
``gf2_warp_osd0_kernel``, or the block and device variants'
``gf2_block_kernel<false, false, true, ...>``) over the overlapping-window
decoder's profiled slice: the least time OSD-0 needs on the lanes BP
leaves unconverged in every window (``yardstick/owd.py``: the columns each
lane walks to the pivot that ends it and its pivots, as
``reference/owd.py`` counts them on the slice's shots) over K2''s device
time there, in percent."""

from benchmark.yardstick import owd, work

NAMES = ("gf2_warp_osd0_kernel", "gf2_block_kernel<false, false, true")


def read(ctx):
    events = [e for e in ctx.device_events if any(k in e["name"] for k in NAMES)]
    if not events:
        return None
    moved, ops = owd.osd0(ctx.work()["windows"])
    return 100.0 * work.bound_s(moved, ops) / (sum(e["dur"] for e in events) / 1e6)
