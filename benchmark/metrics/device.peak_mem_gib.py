"""``torch.cuda.max_memory_allocated()`` over the run, before the reference
runs, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
