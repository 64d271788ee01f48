"""Decoder classes with the public API of ``ldpc_tpu.decoders``."""

from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder, SoftInfoBpDecoder  # noqa: F401
from ldpc_tpu_torch.decoders.bposd_decoder import SoftInfoBpOsdDecoder  # noqa: F401
