"""Code constructions (host-side, scipy CSR): the port's own copy of
the JAX package's ``codes``."""

from ldpc_tpu_torch.codes.classical import (
    rep_code,
    ring_code,
    hamming_code,
    random_binary_code,
)
from ldpc_tpu_torch.codes.css import (
    hgp,
    hgp_code,
    surface_code,
    toric_code,
    bivariate_bicycle_code,
)

__all__ = [
    "rep_code",
    "ring_code",
    "hamming_code",
    "random_binary_code",
    "hgp",
    "hgp_code",
    "surface_code",
    "toric_code",
    "bivariate_bicycle_code",
]
