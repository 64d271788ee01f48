"""Host syncs a call: torch's sync debug mode over calls kept outside the
profiled slice (``yardstick/syncs.py``)."""


def read(ctx):
    return ctx.syncs_per_call
