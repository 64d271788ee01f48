"""Protograph / quasi-cyclic LDPC algebra
(reference: src_python/ldpc/protograph.py).

Elements of the ring of circulants over F2 are represented by the list
of their nonzero shift exponents; a protograph is a 2-D object array of
such elements, lifted to a binary matrix by replacing each element with
the XOR of the corresponding cyclic permutation matrices.
"""

import copy as cp

import numpy as np


def permutation_matrix(n: int, shift: int) -> np.ndarray:
    """The n x n cyclic shift matrix (identity rolled by ``shift``
    columns; reference: protograph.py:5-21)."""
    return np.roll(np.identity(n, dtype=int), shift, axis=1)


class RingOfCirculantsF2:
    """An element of the ring of circulants over F2, stored as the
    sorted set of shift exponents with odd multiplicity
    (reference: protograph.py:23-170)."""

    def __init__(self, non_zero_coefficients):
        try:
            coeffs = list(non_zero_coefficients)
        except TypeError:
            coeffs = [non_zero_coefficients]
        coeffs = np.asarray(coeffs, dtype=int)
        if coeffs.ndim != 1:
            raise TypeError(
                "The input to RingOfCirculantsF2 must be a one-dimensional list"
            )
        values, counts = np.unique(coeffs, return_counts=True)
        self.coefficients = values[counts % 2 == 1]

    def __add__(self, other):
        return RingOfCirculantsF2(
            np.concatenate([self.coefficients, other.coefficients])
        )

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return self.__rmul__(other)
        if not isinstance(other, RingOfCirculantsF2):
            raise TypeError(
                "Ring elements can only be multiplied by other ring "
                f"elements. Not by {type(other)}"
            )
        # product of polynomials: sum of all exponent pairs
        prods = [
            a + b for a in self.coefficients for b in other.coefficients
        ]
        return RingOfCirculantsF2(prods)

    def __rmul__(self, other):
        if isinstance(other, (int, float)):
            return RingOfCirculantsF2(()) if int(other) % 2 == 0 else self

    def __eq__(self, other):
        if isinstance(other, RingOfCirculantsF2):
            return (
                self.coefficients.shape == other.coefficients.shape
                and sorted(self.coefficients) == sorted(other.coefficients)
            )
        if other is None:
            return False
        if len(self.coefficients) == len(other):
            return (self.coefficients == np.asarray(other)).all()
        return False

    @property
    def T(self):
        """Transpose: negate every shift (reference: protograph.py:105-115)."""
        return RingOfCirculantsF2(-1 * self.coefficients)

    def len(self) -> int:
        return len(self.coefficients)

    def __len__(self) -> int:
        return len(self.coefficients)

    def __repr__(self):
        return "(" + ",".join(str(int(v)) for v in self.coefficients) + ")"

    def __str__(self):
        return "λ" + self.__repr__()

    def to_binary(self, lift_parameter: int) -> np.ndarray:
        """XOR of the shift matrices of each coefficient
        (reference: protograph.py:155-170)."""
        mat = np.zeros((lift_parameter, lift_parameter), dtype=int)
        for coeff in self.coefficients:
            mat += permutation_matrix(lift_parameter, coeff)
        return mat % 2


class array(np.ndarray):
    """A protograph: ndarray of RingOfCirculantsF2 elements
    (reference: protograph.py:173-281)."""

    def __new__(cls, proto_array):
        temp = np.asarray(proto_array, dtype=object)
        if temp.ndim == 3:
            m, n, _ = temp.shape
        elif temp.ndim == 2:
            m, n = temp.shape
        else:
            raise TypeError(
                "The input protograph must be a three-dimensional array "
                "like object or a two-dimensional array with elements that "
                "are tuples"
            )
        flat = np.empty(m * n, dtype=object)
        for idx in range(m * n):
            el = temp[idx // n, idx % n]
            flat[idx] = (
                el
                if isinstance(el, RingOfCirculantsF2)
                else RingOfCirculantsF2(el)
            )
        return flat.reshape(m, n).view(cls)

    @property
    def T(self):
        m, n = self.shape
        temp = np.copy(self)
        for i in range(m):
            for j in range(n):
                temp[i, j] = temp[i, j].T
        return temp.T.view(type(self))

    def to_binary(self, lift_parameter: int) -> np.ndarray:
        L = lift_parameter
        m, n = self.shape
        mat = np.zeros((m * L, n * L), dtype=int)
        for i in range(m):
            for j in range(n):
                mat[i * L : (i + 1) * L, j * L : (j + 1) * L] = self[
                    i, j
                ].to_binary(L)
        return mat

    @property
    def copy(self):
        return cp.deepcopy(self)

    def __str__(self):
        rows = []
        for i in range(self.shape[0]):
            rows.append(" ".join(str(self[i, j]) for j in range(self.shape[1])))
        return "[[" + "]\n [".join(rows) + "]]"


def identity(size: int) -> array:
    """Identity protograph (reference: protograph.py:284-291)."""
    proto = zeros(size)
    for j in range(size):
        proto[j, j] = RingOfCirculantsF2([0])
    return proto


def zeros(size) -> array:
    """All-zero protograph (reference: protograph.py:294-309)."""
    m, n = (size, size) if isinstance(size, int) else (size[0], size[1])
    proto = np.empty((m, n), dtype=object)
    for i in range(m):
        for j in range(n):
            proto[i, j] = RingOfCirculantsF2([])
    return array(proto)


def hstack(proto_list) -> array:
    return np.hstack(proto_list).view(array)


def vstack(proto_list) -> array:
    return np.vstack(proto_list).view(array)
