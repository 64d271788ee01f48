"""Code-parameter utilities.

API parity with ``ldpc.code_util``
(reference: src_python/ldpc/code_util/code_util.py), backed by the
``ldpc_tpu_torch.mod2`` packed-word GF(2) toolbox.
"""

from ldpc_tpu_torch.code_util.code_util import (  # noqa: F401
    compute_avg_hamming_weights,
    compute_code_dimension,
    compute_code_parameters,
    compute_exact_code_distance,
    construct_generator_matrix,
    estimate_code_distance,
    search_cycles,
)
from ldpc_tpu_torch.code_util._legacy_v1 import compute_code_distance  # noqa: F401

__all__ = [
    "compute_code_distance",
    "construct_generator_matrix",
    "estimate_code_distance",
    "compute_code_dimension",
    "compute_code_parameters",
    "compute_exact_code_distance",
    "search_cycles",
    "compute_avg_hamming_weights",
]
