"""The benchmark's own code constructions (numpy, dense 0/1 uint8).

The configurations name a code by family and distance; these build its
check matrix ``hx`` without the program, so that the program and the plain
reference are handed the same matrix from outside.

- ``surface``: the unrotated surface code, the hypergraph product of two
  distance-d repetition codes (H[i, i] = H[i, i + 1] = 1).
- ``toric``: the toric code, the hypergraph product of two distance-d ring
  codes (the repetition code plus the row closing the loop).

For check matrices h1 (m1 x n1) and h2 (m2 x n2) the product's X checks
are ``hx = [h1 (x) I(n2) | I(m1) (x) h2^T]`` (Tillich and Zemor,
arXiv:0903.0566).
"""

import numpy as np


def repetition(d: int) -> np.ndarray:
    h = np.zeros((d - 1, d), np.uint8)
    i = np.arange(d - 1)
    h[i, i] = 1
    h[i, i + 1] = 1
    return h


def ring(d: int) -> np.ndarray:
    h = np.zeros((d, d), np.uint8)
    i = np.arange(d)
    h[i, i] = 1
    h[i, (i + 1) % d] = 1
    return h


def hypergraph_product(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """``hx`` of the hypergraph product of ``h1`` and ``h2``."""
    m1, n1 = h1.shape
    m2, n2 = h2.shape
    return np.hstack([np.kron(h1, np.eye(n2, dtype=np.uint8)),
                      np.kron(np.eye(m1, dtype=np.uint8), h2.T)]).astype(np.uint8)


def _row_reduce(a: np.ndarray):
    """Reduced row echelon form over GF(2) and its pivot columns."""
    a = a.copy() % 2
    pivots, r = [], 0
    for c in range(a.shape[1]):
        rows = np.flatnonzero(a[r:, c]) + r
        if rows.size == 0:
            continue
        a[[r, rows[0]]] = a[[rows[0], r]]
        hit = np.flatnonzero(a[:, c])
        hit = hit[hit != r]
        a[hit] ^= a[r]
        pivots.append(c)
        r += 1
        if r == a.shape[0]:
            break
    return a[:r], pivots


def rank(a: np.ndarray) -> int:
    return len(_row_reduce(a)[1])


def build(code: dict) -> np.ndarray:
    """``hx`` of a configuration's ``code`` entry: ``{"family": "surface" |
    "toric", "distance": d}``."""
    h = {"surface": repetition, "toric": ring}[code["family"]](int(code["distance"]))
    return hypergraph_product(h, h)
