"""The least time K1' could take on the window decoder's BP, window by
window, from the work that ``reference/window.py`` counts on the same
shots: every lane to its convergence or the cap, on the window's
space-time matrix, each lane with its own prior.

``yardstick/owd.py``'s ``k1`` counts one (n,) prior a launch; a launch on
a per-lane prior also reads each lane's (n,) float32 row of the (B, n)
prior once, so ``4 n`` bytes a lane are added to it. Every input byte is counted read once and
every output byte written once (``yardstick/work.py``'s rule); a kernel's
roofline share is ``bound_s / measured_s``.
"""

from benchmark.yardstick import owd


def k1(windows: list) -> tuple:
    """K1' over the windows, one launch a window, each lane on its own
    prior: ``(bytes, operations)``."""
    moved, ops = owd.k1(windows)
    return moved + sum(4.0 * w["bp_lanes"] * w["n"] for w in windows), ops
