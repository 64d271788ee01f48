"""Monte-Carlo decoding on the device (port of ``ldpc_tpu.monte_carlo_simulation``)."""

from ldpc_tpu_torch.monte_carlo_simulation.device_mc import (
    DeviceMonteCarlo,
    make_mc_decoder_step,
)

__all__ = ["DeviceMonteCarlo", "make_mc_decoder_step"]
