"""Classical code parameter tools (reference:
src_python/ldpc/code_util/code_util.py)."""

import warnings
from itertools import combinations
from math import comb
from typing import Tuple, Union

import numpy as np
import scipy.sparse

from ldpc_tpu_torch import mod2


def construct_generator_matrix(pcm) -> scipy.sparse.spmatrix:
    """Generator matrix G with H @ G.T = 0 (mod 2): a basis of ker(H)
    (reference: code_util.py:10-57)."""
    return mod2.nullspace(pcm)


def estimate_code_distance(
    pcm,
    timeout_seconds: float = 0.025,
    number_of_words_to_save: int = 10,
):
    """Randomized search for low-weight codewords
    (reference: code_util.py:59-89). Returns ``(d_estimate, samples
    searched, sparse matrix of the lightest words found)``."""
    return mod2.estimate_code_distance(
        pcm, timeout_seconds, number_of_words_to_save
    )


def compute_code_dimension(pcm) -> int:
    """k = n - rank(H), by rank-nullity (reference: code_util.py:92-109)."""
    return pcm.shape[1] - mod2.rank(pcm, method="dense")


def compute_code_parameters(
    pcm, timeout_seconds: float = 0.025
) -> Tuple[int, int, int]:
    """(n, k, d_estimate) of a parity check matrix
    (reference: code_util.py:112-138)."""
    n = pcm.shape[1]
    k = compute_code_dimension(pcm)
    distance_estimate, _, _ = estimate_code_distance(pcm, timeout_seconds)
    return (n, k, distance_estimate)


def compute_exact_code_distance(pcm) -> int:
    """Exhaustive minimum-distance computation — exponential in n
    (reference: code_util.py:140-176)."""
    if pcm.shape[1] > 15:
        warnings.warn(
            "This function has exponential complexity. Not recommended for "
            "large pcms. Use the 'ldpc_tpu_torch.code_util."
            "estimate_code_distance' function instead."
        )
    d = mod2.compute_exact_code_distance(pcm)
    if d == -1:
        raise ValueError(
            "The input matrix has dimension zero and the code distance is "
            "not defined."
        )
    return d


def search_cycles(H, girth, row=None, terminate=True, exclude_rows=()):
    """Search (or count) Tanner-graph cycles of the given girth
    (reference: code_util.py:179-243).

    A cycle of girth 2g corresponds to g rows whose supports pairwise
    overlap so that >= g columns are shared by exactly two of them.
    With ``terminate`` the first hit returns True; otherwise the count
    of cycles is returned. ``row`` restricts the search to cycles
    through that row (its local girth).
    """
    if isinstance(H, scipy.sparse.spmatrix):
        H = np.asarray(H.todense())
    H = np.asarray(H, dtype=int)
    m, n = H.shape
    g = girth // 2
    cycle_count = 0

    if row is None:
        row_sets = combinations(range(m), g)
        fixed = ()
    else:
        banned = set([row]) | set(exclude_rows)
        row_sets = combinations(
            [k for k in range(m) if k not in banned], g - 1
        )
        fixed = (row,)

    for combo in row_sets:
        row_sum = H[list(fixed + combo)].sum(axis=0)
        two_count = int((row_sum == 2).sum())
        if two_count >= g:
            if terminate:
                return True
            cycle_count += comb(two_count, g)
    if terminate:
        return False
    return cycle_count


def compute_avg_hamming_weights(H) -> Tuple[float, float]:
    """(average column weight, average row weight)
    (reference: code_util.py:246-264)."""
    return float(np.mean(H.sum(axis=0))), float(np.mean(H.sum(axis=1)))
