"""Of the span slice's idle device time, the share outside every call's
root span: idle that the harness's loop and the return to the caller
cost, not the program. The device's busy intervals are the slice's trace,
moved onto the spans' clock (``yardstick/spans.py``); None where no shift
holds for some call."""

from benchmark.yardstick import spans as sp


def read(ctx):
    if ctx.span_device_us is None:
        return None
    busy = sp.union(ctx.span_device_us)
    whole = sp.idle_us(busy, ctx.span_slice_ns[0] / 1e3, ctx.span_slice_ns[1] / 1e3)
    inside = sum(sp.idle_us(busy, s.start_ns / 1e3, s.end_ns / 1e3) for s in sp.roots(ctx.spans))
    return 1.0 - inside / whole if whole else None
