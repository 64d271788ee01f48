"""Import-path parity with ``ldpc.belief_find_decoder``
(reference: src_python/ldpc/belief_find_decoder/__init__.py)."""

from ldpc_tpu_torch.decoders.belief_find import BeliefFindDecoder  # noqa: F401
