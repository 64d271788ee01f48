"""Quantum CSS code constructions (host-side, scipy CSR).

The reference library ships CSS parity-check matrices only as test fixtures
(reference: python_test/pcms/*.npz). This module constructs the same
families programmatically so the framework is self-contained:

- ``hgp``: hypergraph-product codes (Tillich-Zemor); HGP of two repetition
  codes yields the planar surface code, HGP of two ring codes the toric code.
- ``bivariate_bicycle_code``: the IBM-style [[2*l*m, k, d]] BB codes used in
  the BASELINE multi-host workload config.

Each constructor returns a ``CssCode`` with ``hx``, ``hz`` (stabilizer
checks) and ``lx``, ``lz`` (logical operators), all scipy CSR uint8.
"""

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ldpc_tpu_torch import mod2
from ldpc_tpu_torch.codes.classical import rep_code, ring_code


@dataclass
class CssCode:
    """A CSS stabilizer code: hx·hzᵀ = 0 (mod 2)."""

    hx: sp.csr_matrix
    hz: sp.csr_matrix
    lx: sp.csr_matrix = None
    lz: sp.csr_matrix = None
    name: str = ""

    @property
    def n(self) -> int:
        return self.hx.shape[1]

    @property
    def k(self) -> int:
        return self.n - mod2.rank(self.hx) - mod2.rank(self.hz)

    def validate(self) -> bool:
        return ((self.hx @ self.hz.T).toarray() % 2 == 0).all()


def _compute_css_logicals(
    hx: sp.csr_matrix, hz: sp.csr_matrix
) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """Logical-X operators: ker(hz) modulo rowspace(hx) — and vice versa."""
    def logicals(stab: sp.csr_matrix, other: sp.csr_matrix) -> sp.csr_matrix:
        ker = mod2.nullspace(other).toarray()  # candidates commute with checks
        stab_d = stab.toarray() % 2
        stacked = np.vstack([stab_d, ker]) % 2
        pivots = mod2.pivot_rows(stacked)
        log_rows = [stacked[p] for p in pivots if p >= stab_d.shape[0]]
        if not log_rows:
            return sp.csr_matrix((0, stab.shape[1]), dtype=np.uint8)
        return sp.csr_matrix(np.array(log_rows, dtype=np.uint8))

    lx = logicals(hx, hz)
    lz = logicals(hz, hx)
    return lx, lz


def hgp(h1: sp.spmatrix, h2: sp.spmatrix, compute_logicals: bool = True) -> CssCode:
    """Hypergraph product of two classical parity-check matrices.

    For h1 (m1 x n1) and h2 (m2 x n2):

        hx = [ h1 ⊗ I(n2) | I(m1) ⊗ h2ᵀ ]
        hz = [ I(n1) ⊗ h2  | h1ᵀ ⊗ I(m2) ]

    giving an [[n1*n2 + m1*m2, k1*k2 + k1ᵀ*k2ᵀ]] CSS code.
    """
    h1 = sp.csr_matrix(h1, dtype=np.uint8)
    h2 = sp.csr_matrix(h2, dtype=np.uint8)
    m1, n1 = h1.shape
    m2, n2 = h2.shape
    hx = sp.hstack(
        [sp.kron(h1, sp.identity(n2, dtype=np.uint8)),
         sp.kron(sp.identity(m1, dtype=np.uint8), h2.T)],
        format="csr", dtype=np.uint8,
    )
    hz = sp.hstack(
        [sp.kron(sp.identity(n1, dtype=np.uint8), h2),
         sp.kron(h1.T, sp.identity(m2, dtype=np.uint8))],
        format="csr", dtype=np.uint8,
    )
    code = CssCode(hx=hx, hz=hz, name="hgp")
    if compute_logicals:
        code.lx, code.lz = _compute_css_logicals(hx, hz)
    return code


# Alias matching common naming in the literature / downstream packages.
hgp_code = hgp


def surface_code(distance: int, compute_logicals: bool = True) -> CssCode:
    """Planar (unrotated) surface code [[d² + (d-1)², 1, d]].

    Constructed as the hypergraph product of two distance-``d`` repetition
    codes. d=13 gives the [[313, 1, 13]] code used for the headline
    benchmark (BASELINE.md north-star workload).
    """
    h = rep_code(distance)
    code = hgp(h, h, compute_logicals=compute_logicals)
    code.name = f"surface_{distance}"
    return code


def toric_code(distance: int, compute_logicals: bool = True) -> CssCode:
    """Toric code [[2d², 2, d]] as the hypergraph product of two ring codes."""
    h = ring_code(distance)
    code = hgp(h, h, compute_logicals=compute_logicals)
    code.name = f"toric_{distance}"
    return code


def _cyclic_power(size: int, power: int) -> sp.csr_matrix:
    """x^power as a size x size circulant permutation matrix."""
    rows = np.arange(size)
    cols = (rows + power) % size
    return sp.csr_matrix(
        (np.ones(size, dtype=np.uint8), (rows, cols)), shape=(size, size)
    )


def bivariate_bicycle_code(
    l: int,
    m: int,
    a_terms: Sequence[Tuple[int, int]],
    b_terms: Sequence[Tuple[int, int]],
    compute_logicals: bool = True,
) -> CssCode:
    """Bivariate bicycle code over the group Z_l x Z_m.

    ``a_terms`` / ``b_terms`` list monomials (i, j) meaning x^i * y^j, where
    x = S_l ⊗ I_m and y = I_l ⊗ S_m (S = cyclic shift). The code is

        hx = [A | B],   hz = [Bᵀ | Aᵀ]

    e.g. the [[144, 12, 12]] "gross" code:
    ``bivariate_bicycle_code(12, 6, [(3,0),(0,1),(0,2)], [(0,3),(1,0),(2,0)])``.
    """

    def poly(terms):
        acc = None
        for (i, j) in terms:
            term = sp.kron(_cyclic_power(l, i), _cyclic_power(m, j), format="csr")
            acc = term if acc is None else ((acc + term).astype(np.uint8))
        acc = sp.csr_matrix(acc, dtype=np.uint8)
        acc.data %= 2
        acc.eliminate_zeros()
        return acc

    A = poly(a_terms)
    B = poly(b_terms)
    hx = sp.hstack([A, B], format="csr", dtype=np.uint8)
    hz = sp.hstack([B.T, A.T], format="csr", dtype=np.uint8)
    code = CssCode(hx=hx, hz=hz, name=f"bb_{l}_{m}")
    if compute_logicals:
        code.lx, code.lz = _compute_css_logicals(hx, hz)
    return code
