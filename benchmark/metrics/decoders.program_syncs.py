"""Host syncs a call that the program counts itself (its ``sync.*``
counters), over the span slice: unlike ``decoders.host_syncs``, no sync of
torch's own (a one-time warning) is in it."""


def read(ctx):
    syncs = [v for name, v in ctx.counters.items() if name.startswith("sync.")]
    return sum(syncs) / ctx.span_calls if syncs else None
