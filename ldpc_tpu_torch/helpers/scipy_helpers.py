"""Input validation of parity-check matrices (host-side).

The port's own copy of the JAX package's ``helpers.scipy_helpers``, with
the same errors and messages (reference:
src_python/ldpc/helpers/scipy_helpers.py:6-72).
"""

from typing import Union

import numpy as np
import scipy.sparse


def convert_to_binary_sparse(
    matrix: Union[np.ndarray, scipy.sparse.spmatrix],
) -> scipy.sparse.csr_matrix:
    """Validate and convert a matrix to a binary ``uint8`` CSR sparse matrix.

    Accepts a numpy array or any scipy sparse matrix whose entries are all
    0/1 and whose dtype is one of uint8/int8/int/float. Zero entries are
    eliminated from the sparse structure.

    Raises
    ------
    TypeError
        If the input is not a numpy array / scipy sparse matrix, or has a
        disallowed dtype.
    ValueError
        If the matrix contains entries other than 0 and 1.
    """
    if not isinstance(matrix, (np.ndarray, scipy.sparse.spmatrix)):
        raise TypeError(
            f"Input must be a binary numpy array or scipy sparse matrix, not {type(matrix)}"
        )

    if matrix.dtype not in (np.uint8, np.int8, int, float, np.int32, np.int64):
        raise TypeError(
            f"Input matrix must have dtype uint8, int8, or int, not {matrix.dtype}"
        )

    if isinstance(matrix, np.ndarray):
        if not np.all(np.isin(matrix, (0, 1))):
            raise ValueError("Input matrix must be a binary matrix.")
        return scipy.sparse.csr_matrix(matrix, dtype=np.uint8)

    matrix = matrix.tocsr()
    if not np.all(np.isin(matrix.data, (0, 1))):
        raise ValueError("Input matrix must be a binary matrix.")
    if matrix.dtype != np.uint8:
        matrix = matrix.astype(np.uint8)
    matrix.eliminate_zeros()
    return matrix
