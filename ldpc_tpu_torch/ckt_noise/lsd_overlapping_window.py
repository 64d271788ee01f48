"""BP+LSD overlapping-window decoder (port of
``ldpc_tpu.ckt_noise.lsd_overlapping_window``; reference: src_python/ldpc/ckt_noise/lsd_overlapping_window.py)."""

import numpy as np

from ldpc_tpu_torch.ckt_noise.base_overlapping_window_decoder import (
    BaseOverlappingWindowDecoder,
)
from ldpc_tpu_torch.ckt_noise.config import DEFAULT_LSD_DECODER_ARGS
from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder


class LsdOverlappingWindowDecoder(BaseOverlappingWindowDecoder):
    def __init__(self, model, **kwargs):
        self.decoder_config = {
            **DEFAULT_LSD_DECODER_ARGS,
            **kwargs.pop("decoder_config", {}),
        }
        super().__init__(model=model, **kwargs)

    def _get_dcm(self):
        return self.dem_matrices.check_matrix

    def _get_logical_observables_matrix(self):
        return self.dem_matrices.observables_matrix

    @property
    def _min_weight(self) -> float:
        return 0.0

    def _get_weights(self) -> np.ndarray:
        return self.dem_matrices.priors

    def _init_decoder(self, round_dcm, weights):
        return BpLsdDecoder(
            round_dcm.tocsr(),
            error_channel=list(weights),
            device=self.device,
            **self.decoder_config,
        )

    def _device_scan_postprocess(self):
        # the device windows support the order-0 engines only
        method = self.decoder_config.get("lsd_method", "osd_0")
        order = self.decoder_config.get("lsd_order", 0)
        if str(method).lower() in ("osd_0", "osd0", "lsd_0", "lsd0", 0) and order == 0:
            return "lsd0"
        return None
