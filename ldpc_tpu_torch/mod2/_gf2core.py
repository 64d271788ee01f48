"""Packed-word GF(2) linear algebra core (host-side, numpy).

Binary matrices are packed 64 columns per ``uint64`` word so that row
operations (XOR) run at memory speed. This powers the public ``mod2`` API
(rank / kernel / row echelon / PLU...), which in the reference library is
backed by C++ sparse & dense eliminations
(reference: src_cpp/gf2dense.hpp, src_cpp/gf2sparse_linalg.hpp).

The port's own copy of the numpy path of the JAX package's core; the
batched eliminations of the decoders run on the device (kernels K2'-K5').
The JAX package's optional native C++ backend is not carried over: this
is the host toolbox of set-up time, and numpy is its reference path.
"""

from typing import List, Optional, Tuple, Union

import numpy as np
import scipy.sparse


ArrayLike = Union[np.ndarray, scipy.sparse.spmatrix]


def to_dense_uint8(matrix: ArrayLike) -> np.ndarray:
    """Coerce input to a dense uint8 numpy array (values 0/1)."""
    if isinstance(matrix, scipy.sparse.spmatrix):
        out = np.asarray(matrix.todense(), dtype=np.uint8)
    else:
        out = np.asarray(matrix, dtype=np.uint8)
    if out.ndim != 2:
        out = np.atleast_2d(out)
    return out % 2


def pack_rows(dense: np.ndarray) -> np.ndarray:
    """Pack a (m, n) 0/1 matrix into (m, ceil(n/64)) uint64 words.

    Bit j of the matrix lives at word j//64, bit position j%64 (LSB first).
    """
    m, n = dense.shape
    W = (n + 63) // 64
    padded = np.zeros((m, W * 64), dtype=np.uint8)
    padded[:, :n] = dense & 1
    bits = padded.reshape(m, W, 8, 8)
    bytes_ = np.packbits(bits, axis=-1, bitorder="little").reshape(m, W, 8)
    return bytes_.view(np.uint64).reshape(m, W)


def unpack_rows(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_rows`: (m, W) uint64 -> (m, n) uint8."""
    m, W = packed.shape
    bytes_ = packed.reshape(m, W, 1).view(np.uint8).reshape(m, W * 8)
    bits = np.unpackbits(bytes_, axis=-1, bitorder="little")
    return bits[:, :n].astype(np.uint8)


def _get_col(packed: np.ndarray, j: int) -> np.ndarray:
    """Extract column j of a packed matrix as a 0/1 uint64 vector."""
    w, b = divmod(j, 64)
    return (packed[:, w] >> np.uint64(b)) & np.uint64(1)


def packed_row_reduce(
    packed: np.ndarray,
    n: int,
    full: bool = False,
    col_order: Optional[np.ndarray] = None,
    stop_rank: Optional[int] = None,
) -> Tuple[np.ndarray, int, List[int], List[int]]:
    """In-place Gaussian elimination on a packed matrix.

    Processes columns in ``col_order`` (default 0..n-1). For each column,
    picks the first unused row with a 1 there, swaps it into position
    ``rank``, and XOR-eliminates every other row below (and above when
    ``full=True``).

    Returns ``(packed, rank, pivot_cols, row_perm)`` where ``row_perm`` is
    the final ordering of original row indices (echelon row i =
    original row ``row_perm[i]``).

    """
    m = packed.shape[0]
    order = range(n) if col_order is None else col_order
    rank = 0
    pivot_cols: List[int] = []
    row_perm = list(range(m))
    for j in order:
        if rank == m or (stop_rank is not None and rank >= stop_rank):
            break
        col = _get_col(packed, int(j))
        candidates = np.nonzero(col[rank:])[0]
        if candidates.size == 0:
            continue
        piv = rank + int(candidates[0])
        if piv != rank:
            packed[[rank, piv]] = packed[[piv, rank]]
            row_perm[rank], row_perm[piv] = row_perm[piv], row_perm[rank]
            col[[rank, piv]] = col[[piv, rank]]
        if full:
            elim = col.astype(bool)
            elim[rank] = False
        else:
            elim = np.zeros(m, dtype=bool)
            elim[rank + 1 :] = col[rank + 1 :].astype(bool)
        if elim.any():
            packed[elim] ^= packed[rank]
        pivot_cols.append(int(j))
        rank += 1
    return packed, rank, pivot_cols, row_perm


def row_reduce_dense(
    dense: np.ndarray, full: bool = False
) -> Tuple[np.ndarray, int, np.ndarray, List[int]]:
    """Row echelon form with a tracked transform matrix.

    Returns ``(echelon, rank, transform, pivot_cols)`` with
    ``transform @ dense % 2 == echelon`` (transform is m x m).
    """
    m, n = dense.shape
    aug = np.hstack([dense, np.eye(m, dtype=np.uint8)])
    packed = pack_rows(aug)
    # Eliminate only over the original n columns.
    packed, rank, pivots, _ = packed_row_reduce(packed, n, full=full)
    out = unpack_rows(packed, n + m)
    return out[:, :n], rank, out[:, n:], pivots


def packed_rank(matrix: ArrayLike) -> int:
    dense = to_dense_uint8(matrix)
    packed = pack_rows(dense)
    _, rank, _, _ = packed_row_reduce(packed, dense.shape[1])
    return rank


def packed_kernel(matrix: ArrayLike) -> np.ndarray:
    """Kernel basis of a binary matrix as a (k, n) uint8 array.

    Row-reduces ``[Aᵀ | I]``; rows whose Aᵀ-part vanished give the kernel
    basis in the identity part (reference algorithm: gf2dense.hpp:446-482).
    """
    dense = to_dense_uint8(matrix)
    m, n = dense.shape
    aug = np.hstack([dense.T, np.eye(n, dtype=np.uint8)])
    packed = pack_rows(aug)
    packed, rank, _, _ = packed_row_reduce(packed, m)
    out = unpack_rows(packed, m + n)
    return out[rank:, m:]


def incremental_row_basis(matrix: ArrayLike) -> np.ndarray:
    """Indices of a greedy row basis (first linearly-independent rows).

    Matches the reference's ``pivot_rows`` semantics: PLU on the transpose
    returns pivot columns = the earliest rows that increase the rank
    (reference: gf2dense.hpp:486-489, _mod2.pyx:328).
    """
    dense = to_dense_uint8(matrix)
    m, n = dense.shape
    packed = pack_rows(dense)
    basis_rows: List[int] = []
    # Maintain an echelon basis; add rows greedily.
    ech = np.zeros((0, packed.shape[1]), dtype=np.uint64)
    piv_cols: List[int] = []
    for i in range(m):
        row = packed[i].copy()
        for k, pc in enumerate(piv_cols):
            w, b = divmod(pc, 64)
            if (row[w] >> np.uint64(b)) & np.uint64(1):
                row ^= ech[k]
        nz = np.nonzero(row)[0]
        if nz.size == 0:
            continue
        w = int(nz[0])
        v = int(row[w])
        b = (v & -v).bit_length() - 1
        piv_cols.append(w * 64 + b)
        ech = np.vstack([ech, row[None, :]])
        basis_rows.append(i)
    return np.array(basis_rows, dtype=int)
