"""Decoder classes with the public API of ``ldpc_tpu.decoders``."""
