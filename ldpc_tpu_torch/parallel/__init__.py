"""Decoding along the rounds axis (port of ``ldpc_tpu.parallel``, single
device): the sliding-window decoder of recorded syndrome histories."""

from ldpc_tpu_torch.parallel.window import (  # noqa: F401
    WindowDecodeResult,
    make_window_decoder,
)

__all__ = ["WindowDecodeResult", "make_window_decoder"]
