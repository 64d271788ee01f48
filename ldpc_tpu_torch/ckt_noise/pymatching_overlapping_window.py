"""PyMatching (MWPM) overlapping-window decoder, a copy of
``ldpc_tpu.ckt_noise.pymatching_overlapping_window`` (reference: src_python/ldpc/ckt_noise/pymatching_overlapping_window.py).

pymatching is an optional dependency; it is imported lazily at decoder
construction.
"""

import numpy as np

from ldpc_tpu_torch.ckt_noise.base_overlapping_window_decoder import (
    BaseOverlappingWindowDecoder,
)

_MAX_WEIGHT = 16777215


class PyMatchingOverlappingWindowDecoder(BaseOverlappingWindowDecoder):
    def __init__(self, model, **kwargs):
        self.decoder_config = kwargs.pop("decoder_config", {})
        super().__init__(model=model, **kwargs)

    def _get_dcm(self):
        # matching decoders work on the edge (<=2 detectors) matrix
        return self.dem_matrices.edge_check_matrix

    def _get_logical_observables_matrix(self):
        return self.dem_matrices.edge_observables_matrix

    @property
    def _min_weight(self) -> float:
        import sys

        min_float = sys.float_info.min
        return float(np.clip(-np.log(min_float), -_MAX_WEIGHT, _MAX_WEIGHT))

    def _get_weights(self) -> np.ndarray:
        """Edge log-likelihood weights from the hyperedge priors
        (reference: pymatching_overlapping_window.py:61-67)."""
        probs = (
            self.dem_matrices.hyperedge_to_edge_matrix
            @ self.dem_matrices.priors
        )
        probs[probs == 0] = 1e-308
        return np.clip(
            np.log1p(probs) - np.log(probs), -_MAX_WEIGHT, _MAX_WEIGHT
        )

    def _init_decoder(self, round_dcm, weights):
        from pymatching import Matching  # optional dependency

        return Matching.from_check_matrix(
            round_dcm, weights, **self.decoder_config
        )
