"""Host ms a call in the post-processor's ``osd`` span (the reliability
order, K3''s export and the candidate sweep, with their launches and host
work), over the span slice."""


def read(ctx):
    row = ctx.span_table.get("osd")
    return None if row is None else row["ms"]
