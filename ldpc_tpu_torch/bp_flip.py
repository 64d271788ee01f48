"""Import-path parity with ``ldpc.bp_flip``
(reference: src_python/ldpc/bp_flip/__init__.py)."""

from ldpc_tpu_torch.decoders.bp_flip import BpFlipDecoder  # noqa: F401
