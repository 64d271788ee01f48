"""MacKay alist file IO (reference: src_python/ldpc/alist.py).

The alist format (as written by the reference, which stores the
*transpose* of the input matrix: alist.py:26-27): line 1 = "n m",
line 2 = "max_col_wt max_row_wt", line 3/4 = per-column/per-row weights,
then 1-indexed row positions per column and column positions per row.
"""

import numpy as np


def save_alist(name, mat, j=None, k=None) -> None:
    """Save a numpy array to an alist file (reference: alist.py:4-58)."""
    H = np.asarray(mat).T
    m, n = H.shape
    col_wts = H.sum(axis=0).astype(int)
    row_wts = H.sum(axis=1).astype(int)
    if j is None:
        j = int(col_wts.max())
    if k is None:
        k = int(row_wts.max())
    lines = [f"{n} {m}", f"{j} {k}"]
    lines.append(" ".join(str(int(w)) for w in col_wts) + " ")
    lines.append(" ".join(str(int(w)) for w in row_wts) + " ")
    for col in range(n):
        rows = np.flatnonzero(H[:, col]) + 1
        lines.append(" ".join(map(str, rows)) + " ")
    for row in range(m):
        cols = np.flatnonzero(H[row]) + 1
        lines.append(" ".join(map(str, cols)) + " ")
    with open(name, "w") as f:
        f.write("\n".join(lines) + "\n")


def numpy2alist(name, mat, j=None, k=None) -> None:
    """Alias of :func:`save_alist` (reference: alist.py:61-62)."""
    return save_alist(name, mat, j, k)


def alist2numpy(fname) -> np.ndarray:
    """Load an alist file back into a dense numpy matrix
    (reference: alist.py:65-82). Note the matrix returned is the one
    whose transpose :func:`save_alist` wrote (round-trips with it)."""
    with open(fname) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    m, n = (int(v) for v in lines[0].split()[:2])
    mat = np.zeros((m, n), dtype=int)
    for i in range(m):
        cols = np.array(
            [int(v) for v in lines[i + 4].split() if v.isdigit()], dtype=int
        )
        mat[i, cols - 1] = 1
    return mat
