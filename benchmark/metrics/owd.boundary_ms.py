"""Host ms a call in the overlapping-window decoder's host loop: its
``owd.window`` spans (the boundary windows, each a ``BpOsdDecoder`` call
with the OWD's slicing and syndrome update) and ``owd.bookkeeping`` (the
rows rebuilt after the device windows), over the span slice."""


def read(ctx):
    rows = [ctx.span_table[k]["ms"] for k in ("owd.window", "owd.bookkeeping")
            if k in ctx.span_table]
    return sum(rows) if rows else None
