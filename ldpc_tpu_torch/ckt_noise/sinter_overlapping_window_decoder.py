"""sinter wrappers for the overlapping-window decoders (port of
``ldpc_tpu.ckt_noise.sinter_overlapping_window_decoder``; reference:
src_python/ldpc/ckt_noise/sinter_overlapping_window_decoder.py). The
keyword arguments, ``device`` among them, go to the decoder class.
"""

import pathlib

import numpy as np

try:  # sinter is optional
    import sinter

    _Decoder = sinter.Decoder
    _CompiledDecoder = sinter.CompiledDecoder
except ImportError:  # pragma: no cover
    class _Decoder:
        pass

    class _CompiledDecoder:
        pass

from ldpc_tpu_torch.ckt_noise.bposd_overlapping_window import (
    BpOsdOverlappingWindowDecoder,
)
from ldpc_tpu_torch.ckt_noise.lsd_overlapping_window import (
    LsdOverlappingWindowDecoder,
)
from ldpc_tpu_torch.ckt_noise.pymatching_overlapping_window import (
    PyMatchingOverlappingWindowDecoder,
)


class SinterCompiledDecoder_OWD_Base(_CompiledDecoder):
    """(reference: sinter_overlapping_window_decoder.py:15-33)"""

    def __init__(self, decoder):
        self.decoder = decoder

    def decode_shots_bit_packed(
        self, *, bit_packed_detection_event_data: np.ndarray
    ) -> np.ndarray:
        return self.decoder.decode_batch(
            shots=bit_packed_detection_event_data,
            bit_packed_shots=True,
            bit_packed_predictions=True,
        )


class SinterDecoder_Base_OWD(_Decoder):
    """(reference: sinter_overlapping_window_decoder.py:36-105)"""

    def __init__(self, Decoder_cls, **decoder_kwargs):
        self.Decoder_cls = Decoder_cls
        self.decoder_kwargs = decoder_kwargs

    def compile_decoder_for_dem(self, *, dem):
        return SinterCompiledDecoder_OWD_Base(
            self.Decoder_cls(dem, **self.decoder_kwargs)
        )

    def decode_via_files(
        self,
        *,
        num_shots: int,
        num_dets: int,
        num_obs: int,
        dem_path: pathlib.Path,
        dets_b8_in_path: pathlib.Path,
        obs_predictions_b8_out_path: pathlib.Path,
        tmp_dir: pathlib.Path,
    ) -> None:
        import stim  # optional dependency

        dem = stim.DetectorErrorModel.from_file(dem_path)
        decoder = self.Decoder_cls(dem, **self.decoder_kwargs)
        shots = stim.read_shot_data_file(
            path=dets_b8_in_path,
            format="b8",
            num_detectors=dem.num_detectors,
            bit_packed=False,
        )
        predictions = decoder.decode_batch(shots)
        stim.write_shot_data_file(
            data=predictions,
            path=obs_predictions_b8_out_path,
            format="b8",
            num_observables=dem.num_observables,
        )


class SinterDecoder_BPOSD_OWD(SinterDecoder_Base_OWD):
    def __init__(self, **decoder_kwargs):
        super().__init__(BpOsdOverlappingWindowDecoder, **decoder_kwargs)


class SinterDecoder_LSD_OWD(SinterDecoder_Base_OWD):
    def __init__(self, **decoder_kwargs):
        super().__init__(LsdOverlappingWindowDecoder, **decoder_kwargs)


class SinterDecoder_PyMatching_OWD(SinterDecoder_Base_OWD):
    def __init__(self, **decoder_kwargs):
        super().__init__(PyMatchingOverlappingWindowDecoder, **decoder_kwargs)
