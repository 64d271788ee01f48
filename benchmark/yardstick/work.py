"""The least time a kernel could take on the inputs it was given.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``k1_ops``, ``gf2_ops`` and
of the byte counts of its ``k1_time`` and ``time_elim``, rewritten to take
plain counts: the graph's sizes and the work that the benchmark's plain
reference counts on the same inputs (each BP lane to its convergence or
the cap; each OSD lane's elimination to its last pivot). Every input byte is counted read once and every output byte
written once; a kernel's roofline share is ``bound_s / measured_s``.
"""

from benchmark.yardstick.peaks import HBM_BYTES_PER_S, OPS_PER_S

WORD_BITS = 32  # a packed GF(2) row word of the kernels' layout


def bound_s(bytes_moved: float, ops: float) -> float:
    """The larger of the two floors, in seconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / OPS_PER_S)


def k1_ops(nnz: int, n: int, lane_iterations: int) -> float:
    """Min-sum operations of parallel BP: per edge 7 in the check update
    (subtract, abs, two min compares, sign test, scale, sign select), 1 in
    the bit sum and 1 in the syndrome test; per bit the hard decision."""
    return float(lane_iterations) * (9 * nnz + n)


def k1_bytes(m: int, n: int, dc: int, dv: int, lanes: int, launches: int) -> float:
    """Each lane's syndrome read and its decision (uint8), posterior
    (float32), flag and iteration count written; the prior and the graph's
    two index tables (int32) read once a launch."""
    return float(lanes) * (m + 5 * n + 5) + float(launches) * (4 * n + 4 * m * dc + 4 * n * dv)


def gf2_ops(m: int, steps: int, pivot_words: int) -> float:
    """GF(2) elimination: each column step tests the column bit of the m
    rows; each pivot reads its row's words. A floor: the XORs into the rows
    holding a 1 are not counted."""
    return float(steps) * m + float(pivot_words)


def export_bytes(m: int, n: int, lanes: int, steps: int, launches: int) -> float:
    """Reduced-matrix export (K3'): each lane's syndrome read, its reduced
    [H | s] (int32 words), pivot columns (int32) and used rows written, the
    order entries it walks read; the packed matrix once a launch."""
    words = -(-(n + 1) // WORD_BITS)
    per_lane = m + 4 * m * words + 4 * m + m
    return float(lanes) * per_lane + 4.0 * steps + float(launches) * 4 * m * words


def row_words(n: int) -> int:
    """Words of a full packed row of [H | s]."""
    return -(-(n + 1) // WORD_BITS)


def sweep_bytes(m: int, n: int, lanes: int, pivots: int) -> float:
    """OSD-w candidate sweep: each lane's reduced [H | s] (int32 words),
    pivot columns (int32) and used rows (uint8) read, its k = n - rank
    non-pivot columns (int64) read, and its two decodings (OSD-0 and the
    best candidate, uint8) written, each once; k summed over the lanes is
    ``lanes * n - pivots``."""
    per_lane = 4 * m * row_words(n) + 4 * m + m + 2 * n
    return float(lanes) * per_lane + 8.0 * (float(lanes) * n - pivots)
