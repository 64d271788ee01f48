"""The least time the overlapping-window decoder's kernels could take on
the inputs they were given, window by window, from the work that
``reference/owd.py`` counts on the same shots: each window's own columns
(the program's boundary windows carry every column of the DEM, the rest
zero in their rows; their reading counts as waste), BP's lanes to their
convergence or the cap, OSD-0's lanes to the pivot that ends each.

Every input byte is counted read once and every output byte written once
(``yardstick/work.py``'s rule); a kernel's roofline share is ``bound_s /
measured_s``.
"""

from benchmark.yardstick import work


def k1(windows: list) -> tuple:
    """K1' over the windows: ``(bytes, operations)``; each window's prior
    and graph read once (``work.k1_bytes`` with one launch)."""
    moved = sum(work.k1_bytes(w["m"], w["n"], w["dc"], w["dv"], w["bp_lanes"], 1)
                for w in windows)
    ops = sum(work.k1_ops(w["nnz"], w["n"], w["bp_lane_iterations"]) for w in windows)
    return moved, ops


def osd0_bytes(m: int, n: int, dv: int, lanes: int, steps: int) -> float:
    """K2' in one window: each lane's syndrome (uint8) read and its decoding
    (uint8) and flag written, the entries of its column order it walks
    (int32) read; the window's table of each column's checks (int32, n x
    dv) read once where any lane runs."""
    return float(lanes) * (m + n + 1) + 4.0 * steps + (4.0 * n * dv if lanes else 0.0)


def osd0(windows: list) -> tuple:
    """K2' over the windows: ``(bytes, operations)``, its operations
    ``work.gf2_ops`` of the columns walked and the pivot rows' words."""
    moved = sum(osd0_bytes(w["m"], w["n"], w["dv"], w["osd_lanes"], w["osd_steps"])
                for w in windows)
    ops = sum(work.gf2_ops(w["m"], w["osd_steps"], w["osd_pivot_words"]) for w in windows)
    return moved, ops
