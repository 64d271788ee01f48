"""sinter adapters for the BP-family decoders (port of
``ldpc_tpu.sinter_decoders.sinter_decoders``; reference:
src_python/ldpc/sinter_decoders/sinter_bposd_decoder.py,
sinter_lsd_decoder.py, sinter_belief_find_decoder.py).

Flow per the sinter `Decoder` contract: load the detector error model,
convert to check/observable matrices
(ckt_noise.dem_matrices.detector_error_model_to_check_matrices),
construct the decoder with the DEM priors as the error channel, decode
shots, project corrections through the observables matrix.

Batched: shots decode through ``decode_batch`` on ``device`` (the CUDA
device unless the caller passes ``device="cpu"``) instead of the
reference's per-shot Python loop (sinter_bposd_decoder.py:118-119).
"""

import pathlib

import numpy as np

try:  # sinter is optional
    import sinter

    _SinterDecoder = sinter.Decoder
    _SinterCompiledDecoder = sinter.CompiledDecoder
except ImportError:  # pragma: no cover
    class _SinterDecoder:  # minimal stand-in so the module imports
        pass

    class _SinterCompiledDecoder:
        pass

from ldpc_tpu_torch.ckt_noise.dem_matrices import (
    detector_error_model_to_check_matrices,
)
from ldpc_tpu_torch.device import resolve_device


class _SinterCompiledBp(_SinterCompiledDecoder):
    """In-process compiled decoder for sinter's fast bit-packed path:
    packed detector shots in, packed observable predictions out. The
    packed shots feed ``decode_batch(bit_packed_syndromes=True)``
    directly — stim's b8 layout IS the decoder's packed layout, so the
    worker never materialises unpacked detector data."""

    def __init__(self, decoder, observables_matrix):
        self.decoder = decoder
        self._obs = np.asarray(observables_matrix.todense(), dtype=np.uint8)

    def decode_shots_bit_packed(
        self, *, bit_packed_detection_event_data: np.ndarray
    ) -> np.ndarray:
        corr = self.decoder.decode_batch(
            bit_packed_detection_event_data, bit_packed_syndromes=True
        )
        predictions = ((corr @ self._obs.T) % 2).astype(np.uint8)
        return np.packbits(predictions, axis=1, bitorder="little")


class _SinterBpBase(_SinterDecoder):
    """Shared decode_via_files / decode_batch_from_dem plumbing."""

    def _make_decoder(self, check_matrix, priors):
        raise NotImplementedError

    def compile_decoder_for_dem(self, *, dem) -> "_SinterCompiledBp":
        """sinter CompiledDecoder hook: keeps the decoder (and its device
        tensors) alive across shot batches in-process, with bit-packed
        IO end to end."""
        matrices = detector_error_model_to_check_matrices(dem)
        decoder = self._make_decoder(
            matrices.check_matrix.tocsr(), matrices.priors
        )
        return _SinterCompiledBp(decoder, matrices.observables_matrix)

    def decode_batch_from_dem(self, dem, shots: np.ndarray) -> np.ndarray:
        """Batch-decode detector shots for a detector error model;
        returns observable predictions (num_shots, num_observables)."""
        matrices = detector_error_model_to_check_matrices(dem)
        decoder = self._make_decoder(
            matrices.check_matrix.tocsr(), matrices.priors
        )
        shots = np.atleast_2d(np.asarray(shots, dtype=np.uint8))
        corr = decoder.decode_batch(shots)
        obs = np.asarray(matrices.observables_matrix.todense())
        return ((corr @ obs.T) % 2).astype(np.uint8)

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
        """sinter worker entry point
        (reference: sinter_bposd_decoder.py:57-130)."""
        import stim  # optional dependency

        dem = stim.DetectorErrorModel.from_file(dem_path)
        shots = stim.read_shot_data_file(
            path=dets_b8_in_path,
            format="b8",
            num_detectors=dem.num_detectors,
            bit_packed=False,
        )
        predictions = self.decode_batch_from_dem(dem, shots)
        stim.write_shot_data_file(
            data=np.asarray(predictions, dtype=np.bool_),
            path=obs_predictions_b8_out_path,
            format="b8",
            num_observables=dem.num_observables,
        )


class SinterBpOsdDecoder(_SinterBpBase):
    """BP+OSD sinter decoder (reference: sinter_bposd_decoder.py:9-56)."""

    def __init__(
        self,
        max_iter=0,
        bp_method="ms",
        ms_scaling_factor=0.625,
        schedule="parallel",
        omp_thread_count=1,
        serial_schedule_order=None,
        osd_method="osd0",
        osd_order=0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_iter = max_iter
        self.bp_method = bp_method
        self.ms_scaling_factor = ms_scaling_factor
        self.schedule = schedule
        self.omp_thread_count = omp_thread_count
        self.serial_schedule_order = serial_schedule_order
        self.osd_method = osd_method
        self.osd_order = osd_order

    def _make_decoder(self, check_matrix, priors):
        from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder

        return BpOsdDecoder(
            check_matrix,
            error_channel=list(priors),
            max_iter=self.max_iter,
            bp_method=self.bp_method,
            ms_scaling_factor=self.ms_scaling_factor,
            schedule=self.schedule,
            omp_thread_count=self.omp_thread_count,
            serial_schedule_order=self.serial_schedule_order,
            device=self.device,
            osd_method=self.osd_method,
            osd_order=self.osd_order,
        )


class SinterLsdDecoder(_SinterBpBase):
    """BP+LSD sinter decoder (reference: sinter_lsd_decoder.py)."""

    def __init__(
        self,
        max_iter=0,
        bp_method="ms",
        ms_scaling_factor=0.625,
        schedule="parallel",
        omp_thread_count=1,
        serial_schedule_order=None,
        lsd_method="lsd0",
        lsd_order=0,
        bits_per_step=1,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_iter = max_iter
        self.bp_method = bp_method
        self.ms_scaling_factor = ms_scaling_factor
        self.schedule = schedule
        self.omp_thread_count = omp_thread_count
        self.serial_schedule_order = serial_schedule_order
        self.lsd_method = lsd_method
        self.lsd_order = lsd_order
        self.bits_per_step = bits_per_step

    def _make_decoder(self, check_matrix, priors):
        from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder

        return BpLsdDecoder(
            check_matrix,
            error_channel=list(priors),
            max_iter=self.max_iter,
            bp_method=self.bp_method,
            ms_scaling_factor=self.ms_scaling_factor,
            schedule=self.schedule,
            omp_thread_count=self.omp_thread_count,
            serial_schedule_order=self.serial_schedule_order,
            device=self.device,
            lsd_method=self.lsd_method,
            lsd_order=self.lsd_order,
            bits_per_step=self.bits_per_step,
        )


class SinterBeliefFindDecoder(_SinterBpBase):
    """BP+UF (BeliefFind) sinter decoder
    (reference: sinter_belief_find_decoder.py)."""

    def __init__(
        self,
        max_iter=0,
        bp_method="ms",
        ms_scaling_factor=0.625,
        schedule="parallel",
        omp_thread_count=1,
        serial_schedule_order=None,
        uf_method="inversion",
        bits_per_step=1,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_iter = max_iter
        self.bp_method = bp_method
        self.ms_scaling_factor = ms_scaling_factor
        self.schedule = schedule
        self.omp_thread_count = omp_thread_count
        self.serial_schedule_order = serial_schedule_order
        self.uf_method = uf_method
        self.bits_per_step = bits_per_step

    def _make_decoder(self, check_matrix, priors):
        from ldpc_tpu_torch.decoders.belief_find import BeliefFindDecoder

        return BeliefFindDecoder(
            check_matrix,
            error_channel=list(priors),
            max_iter=self.max_iter,
            bp_method=self.bp_method,
            ms_scaling_factor=self.ms_scaling_factor,
            schedule=self.schedule,
            omp_thread_count=self.omp_thread_count,
            serial_schedule_order=self.serial_schedule_order,
            device=self.device,
            uf_method=self.uf_method,
            bits_per_step=self.bits_per_step,
        )
