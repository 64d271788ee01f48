"""Import-path parity with ``ldpc.bplsd_decoder``
(reference: src_python/ldpc/bplsd_decoder/__init__.py)."""

from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder  # noqa: F401
