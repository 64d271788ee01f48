"""Import-path parity with ``ldpc.union_find_decoder``
(reference: src_python/ldpc/union_find_decoder/__init__.py)."""

from ldpc_tpu_torch.decoders.union_find import UnionFindDecoder  # noqa: F401
