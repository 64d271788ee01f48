"""Import-path parity with ``ldpc.lsd_decoder``
(reference: src_python/ldpc/lsd_decoder/__init__.py)."""

from ldpc_tpu_torch.decoders.lsd_decoder import LsdDecoder  # noqa: F401
