"""Host ms a call inside the program's ``sync.*`` spans, over the span
slice: the time the host waits for the device (or for a copy) at each of
the decode path's host syncs."""


def read(ctx):
    waits = [row["ms"] for name, row in ctx.span_table.items() if name.startswith("sync.")]
    return sum(waits) if waits else None
