"""GF(2) linear algebra toolbox.

API parity with ``ldpc.mod2`` (reference: src_python/ldpc/mod2/_mod2.pyx).
All functions accept numpy arrays or scipy sparse matrices and are host-side
setup-time tools; the batched GF(2) solves inside the decoders run on the
device (kernels K2'-K5'). The port's own copy of the JAX package's
``mod2``, on its numpy path.
"""

import time
from typing import List, Union

import numpy as np
import scipy.sparse

from ldpc_tpu_torch.mod2._gf2core import (
    ArrayLike,
    incremental_row_basis,
    pack_rows,
    packed_kernel,
    packed_rank,
    packed_row_reduce,
    row_reduce_dense,
    to_dense_uint8,
    unpack_rows,
)
from ldpc_tpu_torch.mod2.mod2_numpy import (
    mod10_to_mod2,
    mod2_to_mod10,
)

__all__ = [
    "rank",
    "kernel",
    "nullspace",
    "row_complement_basis",
    "pivot_rows",
    "io_test",
    "estimate_code_distance",
    "row_span",
    "compute_exact_code_distance",
    "row_basis",
    "row_echelon",
    "reduced_row_echelon",
    "inverse",
    "PluDecomposition",
    "mod10_to_mod2",
    "mod2_to_mod10",
]


def _validate(pcm: ArrayLike) -> None:
    if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
        raise TypeError(
            "The input matrix is of an invalid type. Please input a "
            f"np.ndarray or scipy.sparse.spmatrix object, not {type(pcm)}"
        )


def io_test(pcm: ArrayLike) -> scipy.sparse.csr_matrix:
    """Round-trip a matrix through the internal representation (test hook)."""
    _validate(pcm)
    return scipy.sparse.csr_matrix(to_dense_uint8(pcm))


def rank(pcm: ArrayLike, method: str = "dense") -> int:
    """Rank of a binary matrix over GF(2).

    ``method`` is accepted for API parity ("dense"/"sparse"); both run the
    same packed elimination here (reference: _mod2.pyx:219).
    """
    _validate(pcm)
    if method not in ("dense", "sparse"):
        raise ValueError(
            f"Invalid method. Please use 'dense' or 'sparse', not {method}"
        )
    return packed_rank(pcm)


def nullspace(pcm: ArrayLike, method: str = "dense") -> scipy.sparse.csr_matrix:
    """Kernel basis of ``pcm`` as a (k, n) sparse matrix (reference: _mod2.pyx:261)."""
    _validate(pcm)
    if method not in ("dense", "sparse"):
        raise ValueError("Invalid method. Please use 'dense' or 'sparse'")
    ker = packed_kernel(pcm)
    return scipy.sparse.csr_matrix(ker, shape=(ker.shape[0], pcm.shape[1]))


def kernel(pcm: ArrayLike, method: str = "dense") -> scipy.sparse.csr_matrix:
    """Alias of :func:`nullspace` (reference: _mod2.pyx:301)."""
    return nullspace(pcm, method)


def row_complement_basis(pcm: ArrayLike) -> scipy.sparse.csr_matrix:
    """Unit vectors completing the row space of ``pcm`` to full space.

    Row-reduces ``[pcmᵀ stacked over Iₙ]`` incrementally: the identity rows
    that increase the rank form the complement
    (reference: gf2sparse_linalg.hpp:898-934).
    """
    _validate(pcm)
    dense = to_dense_uint8(pcm)
    m, n = dense.shape
    stacked = np.vstack([dense, np.eye(n, dtype=np.uint8)])
    basis = incremental_row_basis(stacked)
    complement = [i - m for i in basis if i >= m]
    out = np.zeros((len(complement), n), dtype=np.uint8)
    for r, j in enumerate(complement):
        out[r, j] = 1
    return scipy.sparse.csr_matrix(out, shape=(len(complement), n))


def pivot_rows(mat: ArrayLike) -> np.ndarray:
    """Indices of the first linearly-independent rows (reference: _mod2.pyx:328)."""
    _validate(mat)
    return incremental_row_basis(mat)


def row_basis(pcm: ArrayLike) -> scipy.sparse.csr_matrix:
    """The submatrix of linearly independent rows (reference: _mod2.pyx:460)."""
    from ldpc_tpu_torch.helpers import convert_to_binary_sparse

    pcm = convert_to_binary_sparse(pcm)
    pivots = pivot_rows(pcm)
    return pcm[pivots, :]


def row_span(pcm: ArrayLike) -> scipy.sparse.csr_matrix:
    """All 2^m XOR combinations of the rows of ``pcm`` (reference: _mod2.pyx:407).

    Warning: output has 2^row_count rows; only use on small matrices.
    """
    _validate(pcm)
    dense = to_dense_uint8(pcm)
    m, n = dense.shape
    count = 1 << m
    selectors = (
        (np.arange(count, dtype=np.uint64)[:, None] >> np.arange(m, dtype=np.uint64))
        & 1
    ).astype(np.uint8)
    span = (selectors @ dense) % 2
    return scipy.sparse.csr_matrix(span.astype(np.uint8), shape=(count, n))


def estimate_code_distance(
    pcm: ArrayLike,
    timeout_seconds: float = 0.025,
    number_of_words_to_save: int = 10,
):
    """Randomized estimate of the minimum distance of ker(pcm).

    Samples random sparse combinations of kernel basis words (each basis
    word included with probability 2/k) until the timeout, tracking the
    lowest weights seen (reference: gf2dense.hpp:522-654,657-686).

    Returns ``(min_distance, samples_searched, min_weight_words_matrix)``.
    """
    _validate(pcm)
    n = pcm.shape[1]
    ker = packed_kernel(pcm)
    k = ker.shape[0]
    if k == 0:
        return np.iinfo(np.int32).max, 0, scipy.sparse.csr_matrix(
            (number_of_words_to_save, n), dtype=np.uint8
        )
    packed_ker = pack_rows(ker)
    rng = np.random.default_rng()
    sample_prob = min(1.0, 2.0 / k)

    saved: List[np.ndarray] = [w for w in ker if w.any()]
    saved.sort(key=lambda w: int(w.sum()))
    saved = saved[:number_of_words_to_save]
    min_distance = min((int(w.sum()) for w in saved), default=n)

    start = time.perf_counter()
    samples = 0
    # Vectorized batches of random combinations.
    batch = 256
    while time.perf_counter() - start < timeout_seconds:
        mask = rng.random((batch, k)) < sample_prob
        words_packed = np.zeros((batch, packed_ker.shape[1]), dtype=np.uint64)
        for i in range(k):
            rows = mask[:, i]
            if rows.any():
                words_packed[rows] ^= packed_ker[i]
        weights = np.array(
            [bin(int.from_bytes(w.tobytes(), "little")).count("1") for w in words_packed]
        )
        samples += batch
        nonzero = weights > 0
        if nonzero.any():
            best = int(weights[nonzero].min())
            if best < min_distance:
                min_distance = best
            order = np.argsort(weights[nonzero])
            cand_words = unpack_rows(words_packed[nonzero][order[:4]], n)
            for w in cand_words:
                saved.append(w.astype(np.uint8))
            saved.sort(key=lambda w: int(w.sum()))
            saved = saved[:number_of_words_to_save]

    words = np.zeros((number_of_words_to_save, n), dtype=np.uint8)
    for i, w in enumerate(saved[:number_of_words_to_save]):
        words[i] = w
    return min_distance, samples, scipy.sparse.csr_matrix(words)


def compute_exact_code_distance(pcm: ArrayLike) -> int:
    """Exact minimum distance of ker(pcm) by exhaustive kernel enumeration.

    Returns -1 when the kernel is trivial
    (reference: gf2dense.hpp:686-735). Exponential in dim ker — small codes only.
    """
    _validate(pcm)
    ker = packed_kernel(pcm)
    k, n = ker.shape
    if k == 0:
        return -1
    distance = n
    packed_ker = pack_rows(ker)
    current = np.zeros(packed_ker.shape[1], dtype=np.uint64)
    # Gray-code enumeration: each step flips one basis word.
    prev_gray = 0
    for i in range(1, 1 << k):
        gray = i ^ (i >> 1)
        flip = (gray ^ prev_gray).bit_length() - 1
        prev_gray = gray
        current ^= packed_ker[flip]
        weight = bin(int.from_bytes(current.tobytes(), "little")).count("1")
        if 0 < weight < distance:
            distance = weight
    return distance


def row_echelon(
    matrix: ArrayLike, full: bool = False
) -> List:
    """Row echelon form of a binary matrix.

    Returns ``[echelon_form, rank, transform, pivot_cols]`` with
    ``transform @ matrix % 2 == echelon_form``
    (reference: _mod2.pyx:481, mod2_numpy.py:68).
    """
    _validate(matrix)
    dense = to_dense_uint8(matrix)
    ech, rk, transform, pivots = row_reduce_dense(dense, full=full)
    return [ech, rk, transform, np.array(pivots, dtype=int)]


def reduced_row_echelon(matrix: ArrayLike) -> List:
    """Reduced row echelon form with pivots moved to the identity block.

    Returns ``[rre, rank, transform_rows, transform_cols]`` such that
    ``transform_rows @ matrix @ transform_cols % 2 == rre`` and the leading
    rank x rank block of ``rre`` is the identity
    (reference: _mod2.pyx:529, mod2_numpy.py:210).
    """
    _validate(matrix)
    dense = to_dense_uint8(matrix)
    m, n = dense.shape
    ech, rk, transform, pivots = row_reduce_dense(dense, full=True)
    # Column permutation moving pivot columns to the front.
    non_pivots = [j for j in range(n) if j not in set(pivots)]
    perm = list(pivots) + non_pivots
    transform_cols = np.zeros((n, n), dtype=np.uint8)
    for new_j, old_j in enumerate(perm):
        transform_cols[old_j, new_j] = 1
    rre = ech[:, perm]
    return [rre, rk, transform, transform_cols]


def inverse(matrix: ArrayLike) -> np.ndarray:
    """Inverse of an invertible binary matrix over GF(2)
    (reference: _mod2.pyx:569, mod2_numpy.py:361)."""
    _validate(matrix)
    dense = to_dense_uint8(matrix)
    m, n = dense.shape
    ech, rk, transform, _ = row_reduce_dense(dense, full=True)
    if m != n or rk != n:
        raise ValueError("Matrix is not invertible")
    return transform % 2


class PluDecomposition:
    """PLU decomposition of a binary matrix: ``P @ L @ U == pcm`` (mod 2).

    API parity with ``ldpc.mod2.PluDecomposition``
    (reference: _mod2.pyx:630-773; backing C++: gf2sparse_linalg.hpp:132-401).

    Parameters
    ----------
    pcm:
        Binary matrix (numpy or scipy sparse).
    full_reduce:
        When True the U factor is fully reduced above pivots as well.
    lower_triangular:
        Kept for API parity; L is always recorded.
    """

    def __init__(
        self,
        pcm: ArrayLike,
        full_reduce: bool = False,
        lower_triangular: bool = True,
    ) -> None:
        _validate(pcm)
        dense = to_dense_uint8(pcm)
        self._m, self._n = dense.shape
        U = dense.copy()
        m, n = dense.shape
        L = np.eye(m, dtype=np.uint8)
        perm = np.arange(m)
        rank_ = 0
        pivots: List[int] = []
        for j in range(n):
            if rank_ == m:
                break
            col = U[rank_:, j]
            nz = np.nonzero(col)[0]
            if nz.size == 0:
                continue
            piv = rank_ + int(nz[0])
            if piv != rank_:
                U[[rank_, piv]] = U[[piv, rank_]]
                perm[[rank_, piv]] = perm[[piv, rank_]]
                # swap the already-computed sub-diagonal part of L
                L[[rank_, piv], :rank_] = L[[piv, rank_], :rank_]
            below = np.nonzero(U[rank_ + 1 :, j])[0] + rank_ + 1
            if below.size:
                U[below] ^= U[rank_]
                L[below, rank_] = 1
            pivots.append(j)
            rank_ += 1
        self._L = L
        self._U = U % 2
        self._perm = perm
        self._rank = rank_
        self._pivots = np.array(pivots, dtype=int)
        if full_reduce:
            # eliminate above pivots (affects U only; L/P unchanged,
            # so P@L@U == pcm no longer holds — parity with reference flag)
            Ufr = self._U.copy()
            for r in range(rank_ - 1, -1, -1):
                j = pivots[r]
                above = np.nonzero(Ufr[:r, j])[0]
                if above.size:
                    Ufr[above] ^= Ufr[r]
            self._U = Ufr

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def pivots(self) -> np.ndarray:
        """Pivot column indices (length ``rank``)."""
        return self._pivots.copy()

    @property
    def L(self) -> scipy.sparse.csr_matrix:
        return scipy.sparse.csr_matrix(self._L)

    @property
    def U(self) -> scipy.sparse.csr_matrix:
        return scipy.sparse.csr_matrix(self._U)

    @property
    def P(self) -> scipy.sparse.csr_matrix:
        P = np.zeros((self._m, self._m), dtype=np.uint8)
        # row i of (L@U) corresponds to original row perm[i]
        P[self._perm, np.arange(self._m)] = 1
        return scipy.sparse.csr_matrix(P)

    def lu_solve(self, y: Union[np.ndarray, List[int]]) -> np.ndarray:
        """Solve ``pcm @ x = y`` for one solution x (free variables = 0).

        ``y`` must be in the image of ``pcm`` for the result to satisfy the
        system (matches reference contract: _mod2.pyx:661).
        """
        y = np.asarray(y, dtype=np.uint8) % 2
        if y.shape[0] != self._m:
            raise ValueError(f"Input y must have length {self._m}.")
        # forward: L z = P^T y  (apply the recorded row permutation)
        z = y[self._perm].copy()
        for i in range(self._rank):
            below = np.nonzero(self._L[i + 1 :, i])[0] + i + 1
            if z[i]:
                z[below] ^= 1
        # back substitution on U restricted to pivot columns
        x = np.zeros(self._n, dtype=np.uint8)
        for r in range(self._rank - 1, -1, -1):
            j = self._pivots[r]
            acc = z[r]
            row = self._U[r]
            nz = np.nonzero(row)[0]
            for c in nz:
                if c != j:
                    acc ^= x[c]
            x[j] = acc
        return x
