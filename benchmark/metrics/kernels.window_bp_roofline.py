"""K1' on a per-lane prior (``csrc/bp_parallel.cu``: the instances
``bp_warp_kernel<T, CAP, kMinSum, kShared, kLanePrior = true>``) over the
window decoder's profiled slice: the least time the slice's window BP
needs (``yardstick/window.py``: each window's lanes to their convergence or
the cap, each lane's prior read once, as ``reference/window.py`` counts
them on the slice's shots) over those launches' device time there, in
percent."""

from benchmark.yardstick import window, work

KERNEL = "bp_warp_kernel<"


def lane_prior(name: str) -> bool:
    """Whether a kernel event's name is K1' on a per-lane prior: its last
    template argument is true."""
    at = name.find(KERNEL)
    if at < 0:
        return False
    args = name[at + len(KERNEL) :].split(">", 1)[0]
    return args.replace(" ", "").split(",")[-1] == "true"


def read(ctx):
    events = [e for e in ctx.device_events if lane_prior(e["name"])]
    if not events:
        return None
    moved, ops = window.k1(ctx.work()["windows"])
    return 100.0 * work.bound_s(moved, ops) / (sum(e["dur"] for e in events) / 1e6)
