"""Host ms a call in the window decoder's ``window.step`` spans (a
window's difference syndromes, prior, K1' launch, lane selection's sync,
OSD-0 and commit), over the span slice."""


def read(ctx):
    row = ctx.span_table.get("window.step")
    return None if row is None else row["ms"]
