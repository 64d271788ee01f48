"""Host ms a call in the overlapping-window decoder's ``owd.scan`` span
(the device windows: each window's launches and its lane selection's
sync), over the span slice."""


def read(ctx):
    row = ctx.span_table.get("owd.scan")
    return None if row is None else row["ms"]
