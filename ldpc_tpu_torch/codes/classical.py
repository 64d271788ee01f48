"""Classical code constructions (host-side, scipy CSR).

API parity with the reference ``ldpc.codes`` package
(reference: src_python/ldpc/codes/rep_code.py:5,41,
src_python/ldpc/codes/hamming_code.py:5,
src_python/ldpc/codes/random_binary_code.py:7).
"""

from typing import Optional

import numpy as np
import scipy.sparse as sp


def rep_code(distance: int) -> sp.csr_matrix:
    """Parity check matrix of the length-``distance`` repetition code.

    H is (distance-1, distance) with H[i, i] = H[i, i+1] = 1.

    >>> print(rep_code(5).toarray())
    [[1 1 0 0 0]
     [0 1 1 0 0]
     [0 0 1 1 0]
     [0 0 0 1 1]]
    """
    if distance < 2:
        raise ValueError("Distance should be greater than or equal to 2.")
    m = distance - 1
    rows = np.repeat(np.arange(m), 2)
    cols = np.stack([np.arange(m), np.arange(1, m + 1)], axis=1).ravel()
    data = np.ones(2 * m, dtype=np.uint8)
    return sp.csr_matrix((data, (rows, cols)), shape=(m, distance), dtype=np.uint8)


def ring_code(distance: int) -> sp.csr_matrix:
    """Parity check matrix of the closed-loop (ring) repetition code.

    H is (distance, distance): the repetition code plus a row closing the
    loop between the first and last bits.

    >>> print(ring_code(4).toarray())
    [[1 1 0 0]
     [0 1 1 0]
     [0 0 1 1]
     [1 0 0 1]]
    """
    if distance < 2:
        raise ValueError("Distance should be greater than or equal to 2.")
    rows = np.repeat(np.arange(distance), 2)
    cols = np.stack(
        [np.arange(distance), np.roll(np.arange(distance), -1)], axis=1
    ).ravel()
    # match the reference's column ordering: the closing row has entries at
    # columns (0, distance-1)
    data = np.ones(2 * distance, dtype=np.uint8)
    return sp.csr_matrix(
        (data, (rows, cols)), shape=(distance, distance), dtype=np.uint8
    )


def hamming_code(rank: int) -> sp.csr_matrix:
    """Parity check matrix of the [2^rank - 1, 2^rank - 1 - rank, 3] Hamming code.

    Column i (0-indexed) is the binary representation of i+1 over ``rank``
    bits, most-significant bit in row 0.

    >>> print(hamming_code(3).toarray())
    [[0 0 0 1 1 1 1]
     [0 1 1 0 0 1 1]
     [1 0 1 0 1 0 1]]
    """
    if not isinstance(rank, int):
        raise TypeError("The input variable 'rank' must be of type 'int'.")
    n = (1 << rank) - 1
    cols_int = np.arange(1, n + 1, dtype=np.uint32)
    # bit j of (i+1), with row 0 = most significant bit
    H = (cols_int[None, :] >> np.arange(rank - 1, -1, -1, dtype=np.uint32)[:, None]) & 1
    return sp.csr_matrix(H.astype(np.uint8))


def random_binary_code(
    rows: int,
    cols: int,
    row_weight: int,
    seed: Optional[int] = None,
    variance: float = 0,
) -> sp.csr_matrix:
    """Random binary matrix with approximately ``row_weight`` ones per row.

    Each row independently draws its weight from N(row_weight, variance)
    (clamped to [1, cols]) and places that many ones at distinct uniform
    column positions.
    """
    rng = np.random.RandomState(seed) if seed is not None else np.random.RandomState()
    row_indices = []
    col_indices = []
    for row in range(rows):
        w = max(1, int(rng.normal(row_weight, np.sqrt(variance))))
        w = min(w, cols)
        chosen = rng.choice(cols, w, replace=False)
        row_indices.extend([row] * w)
        col_indices.extend(chosen.tolist())
    data = np.ones(len(row_indices), dtype=np.uint8)
    return sp.coo_matrix(
        (data, (row_indices, col_indices)), shape=(rows, cols), dtype=np.uint8
    ).tocsr()
