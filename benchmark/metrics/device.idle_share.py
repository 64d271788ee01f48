"""Share of the timed path's wall in which no kernel, copy or memset ran on
the device: 1 - (union of their intervals in the profiled slice) / (the
slice's calls times the window's mean call wall on the host clock).

The window's unprofiled calls set the wall, not the slice's own: the
profiler's record of every launch slows the host's side of a call (a
launch-bound call runs at about 0.6 of its window rate under it), while a
kernel's or a copy's device time does not change."""


def read(ctx):
    if not ctx.device_events:
        return None
    return 1.0 - ctx.busy_s / (ctx.slice_calls * ctx.window_call_s)
