"""LDPCv1 legacy aliases for ``code_util``
(reference: src_python/ldpc/code_util/_legacy_v1.py)."""

from ldpc_tpu_torch.code_util.code_util import compute_exact_code_distance

__all__ = ["compute_code_distance"]


def compute_code_distance(H):
    """Exact code distance (minimum nonzero-codeword weight) of the code
    with parity-check matrix ``H`` — the LDPCv1 name for
    :func:`compute_exact_code_distance`
    (reference: code_util/_legacy_v1.py:4-24). Exponential in block
    length; practical only for small codes.
    """
    return compute_exact_code_distance(H)
