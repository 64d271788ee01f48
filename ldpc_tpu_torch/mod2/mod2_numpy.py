"""Assorted binary vector/matrix helpers and plain-numpy GF(2) routines.

API parity with ``ldpc.mod2.mod2_numpy``
(reference: src_python/ldpc/mod2/mod2_numpy.py). The heavy lifting is
delegated to the packed-word engine in ``ldpc_tpu_torch.mod2``.
"""

import numpy as np
import scipy.sparse


def mod10_to_mod2(dec, length=0):
    """Decimal -> binary list, left-padded with zeros to ``length``.

    >>> mod10_to_mod2(2, length=5)
    [0, 0, 0, 1, 0]
    """
    bin_str = format(dec, "0{}b".format(length))
    return [int(b) for b in bin_str]


def mod2_to_mod10(binary_arr):
    """Binary list (MSB first) -> decimal int.

    >>> mod2_to_mod10([0, 0, 0, 1, 0])
    2
    """
    bases = 2 ** np.arange(len(binary_arr))[::-1]
    return binary_arr @ bases


def row_echelon(matrix, full=False):
    from ldpc_tpu_torch import mod2

    return mod2.row_echelon(matrix, full=full)


def rank(matrix):
    from ldpc_tpu_torch import mod2

    return mod2.rank(matrix)


def reduced_row_echelon(matrix):
    from ldpc_tpu_torch import mod2

    return mod2.reduced_row_echelon(matrix)


def nullspace(matrix):
    from ldpc_tpu_torch import mod2

    return mod2.nullspace(matrix).toarray()


def row_span(matrix):
    from ldpc_tpu_torch import mod2

    return mod2.row_span(matrix).toarray()


def inverse(matrix):
    from ldpc_tpu_torch import mod2

    return mod2.inverse(matrix)


def row_basis(matrix):
    from ldpc_tpu_torch import mod2

    return mod2.row_basis(matrix).toarray()
