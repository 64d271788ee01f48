"""Device time of host-to-device and device-to-host copies a call, over the
profiled slice, in ms."""


def read(ctx):
    if not ctx.device_events:
        return None
    copies = [e for e in ctx.device_events if e.get("cat") == "gpu_memcpy"]
    return sum(e["dur"] for e in copies) / 1e3 / ctx.slice_calls
