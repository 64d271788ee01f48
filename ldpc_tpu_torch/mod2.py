"""GF(2) rank, kernel and pivot rows of a host matrix (numpy).

The port's own copy of the numpy path of the JAX package's packed-word
GF(2) core: what the code constructions need (``CssCode.k`` and the CSS
logicals) and what :func:`ldpc_tpu_torch.ops.gf2.batched_rank` needs.
Binary matrices are packed 64 columns per ``uint64`` word, LSB first, so
that a row operation is one XOR of words. The batched eliminations of the
decoders run on the device (kernels K2'-K5').
"""

from typing import List, Tuple, Union

import numpy as np
import scipy.sparse

ArrayLike = Union[np.ndarray, scipy.sparse.spmatrix]

__all__ = ["rank", "nullspace", "pivot_rows"]


def _validate(pcm: ArrayLike) -> None:
    if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
        raise TypeError(
            "The input matrix is of an invalid type. Please input a "
            f"np.ndarray or scipy.sparse.spmatrix object, not {type(pcm)}"
        )


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


def packed_row_reduce(packed: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """In-place forward Gaussian elimination on a packed matrix.

    For each column 0..n-1, picks the first unused row with a 1 there,
    swaps it into position ``rank`` and XOR-eliminates every row below it
    holding a 1. Returns ``(packed, rank)``; the first ``rank`` rows are
    the echelon rows.
    """
    m = packed.shape[0]
    rank = 0
    for j in range(n):
        if rank == m:
            break
        col = _get_col(packed, j)
        candidates = np.nonzero(col[rank:])[0]
        if candidates.size == 0:
            continue
        piv = rank + int(candidates[0])
        if piv != rank:
            packed[[rank, piv]] = packed[[piv, rank]]
            col[[rank, piv]] = col[[piv, rank]]
        elim = np.zeros(m, dtype=bool)
        elim[rank + 1 :] = col[rank + 1 :].astype(bool)
        if elim.any():
            packed[elim] ^= packed[rank]
        rank += 1
    return packed, rank


def packed_kernel(matrix: ArrayLike) -> np.ndarray:
    """Kernel basis of a binary matrix as a (k, n) uint8 array.

    Row-reduces ``[Aᵀ | I]``; rows whose Aᵀ-part vanished give the kernel
    basis in the identity part.
    """
    dense = to_dense_uint8(matrix)
    m, n = dense.shape
    aug = np.hstack([dense.T, np.eye(n, dtype=np.uint8)])
    packed = pack_rows(aug)
    packed, rank = packed_row_reduce(packed, m)
    out = unpack_rows(packed, m + n)
    return out[rank:, m:]


def incremental_row_basis(matrix: ArrayLike) -> np.ndarray:
    """Indices of a greedy row basis (the first linearly independent rows)."""
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


def rank(pcm: ArrayLike) -> int:
    """Rank of a binary matrix over GF(2)."""
    _validate(pcm)
    dense = to_dense_uint8(pcm)
    return packed_row_reduce(pack_rows(dense), dense.shape[1])[1]


def nullspace(pcm: ArrayLike) -> scipy.sparse.csr_matrix:
    """Kernel basis of ``pcm`` as a (k, n) sparse matrix."""
    _validate(pcm)
    ker = packed_kernel(pcm)
    return scipy.sparse.csr_matrix(ker, shape=(ker.shape[0], pcm.shape[1]))


def pivot_rows(mat: ArrayLike) -> np.ndarray:
    """Indices of the first linearly independent rows."""
    _validate(mat)
    return incremental_row_basis(mat)
