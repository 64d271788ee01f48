"""Overlapping-window circuit-level decoding (port of
``ldpc_tpu.ckt_noise.base_overlapping_window_decoder``; reference:
src_python/ldpc/ckt_noise/base_overlapping_window_decoder.py).

The measurement-round ("sequence") axis is decoded in sliding windows:
each window's correction commits for the first ``commit`` rounds, the
committed correction's syndrome propagates forward, and committed
error mechanisms are re-weighted to certainty for later windows.

Batched: ``decode_batch`` feeds every shot of a window to the underlying
decoder in ONE ``decode_batch`` call — the reference loops shot-by-shot in
Python (base_overlapping_window_decoder.py:210-218). Windows stay
sequential (their syndrome propagation is causal), shots don't. The
decoders run on ``device`` (the CUDA device unless the caller passes
``device="cpu"``); when the DEM's windows are time-translation invariant
the middle windows run on the device through
:func:`ldpc_tpu_torch.ckt_noise.device_scan.make_device_owd`.

With the recorder of :mod:`ldpc_tpu_torch.utils.profiling` on, a
``decode_batch`` call is the root span ``owd.decode_batch`` (counter
``owd.shots``) over an ``owd.window`` a host-loop window (counter
``owd.windows.host``; a boundary window's ``BpOsdDecoder`` nests its own
``decode_batch`` span in it), the device windows' ``owd.h2d``,
``owd.scan`` (see ``device_scan``), ``owd.d2h`` and ``owd.bookkeeping``,
and ``owd.predict``; each host sync of the OWD's own code is a
``sync.owd_<cause>`` span.
"""

from typing import Tuple

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ldpc_tpu_torch.ckt_noise.dem_matrices import (
    detector_error_model_to_check_matrices,
)
from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.utils.profiling import count, span, sync


class BaseOverlappingWindowDecoder:
    """Base class for overlapping-window decoders over stim DEMs
    (reference: base_overlapping_window_decoder.py:7-137)."""

    def __init__(
        self,
        model,
        decodings: int,
        window: int,
        commit: int,
        num_checks: int,
        device="cuda",
        **decoder_kwargs,
    ) -> None:
        self.device = resolve_device(device)
        self.decodings = decodings
        self.window = window
        self.commit = commit
        self.num_checks = num_checks

        self.dem_matrices = detector_error_model_to_check_matrices(
            model, allow_undecomposed_hyperedges=True
        )
        self.num_detectors = model.num_detectors
        rounds = (self.window - self.commit) + self.decodings * self.commit
        if self.num_detectors % rounds != 0:
            raise ValueError(
                "The number of detectors must be a multiple of the number "
                f"of rounds. There are {self.num_detectors} detectors and "
                f"{rounds} rounds. Dem matrices must be decomposed into a "
                "number of rounds that is a multiple of the number of "
                f"detectors. You expected {self.num_checks * rounds}"
            )
        self.dcm = self._get_dcm()
        self.logical_observables_matrix = (
            self._get_logical_observables_matrix()
        )

    # -- subclass hooks --------------------------------------------------
    def _get_dcm(self) -> csr_matrix:
        raise NotImplementedError(
            "This method must be implemented by the subclass."
        )

    def _get_logical_observables_matrix(self):
        raise NotImplementedError(
            "This method must be implemented by the subclass."
        )

    def _get_weights(self) -> np.ndarray:
        raise NotImplementedError(
            "This method must be implemented by the subclass."
        )

    @property
    def _min_weight(self) -> float:
        raise NotImplementedError(
            "This method must be implemented by the subclass."
        )

    def _init_decoder(self, round_dcm, weights):
        raise NotImplementedError(
            "This method must be implemented by the subclass."
        )

    def _get_decoder(self, decoding, round_dcm, weights):
        if not hasattr(self, "_decoders"):
            self._decoders = {}
        if decoding not in self._decoders:
            self._decoders[decoding] = self._init_decoder(round_dcm, weights)
        return self._decoders[decoding]

    def _device_scan_postprocess(self):
        """Subclass hook: the device-scan window engine matching this
        decoder family ('osd0' / 'lsd0'), or None to disable the scan."""
        return None

    def _maybe_device_scan(self):
        """Build the middle windows' device decoder when the DCM is
        time-translation invariant (ckt_noise/device_scan.py); None keeps
        the pure host loop."""
        if hasattr(self, "_device_scan"):
            return self._device_scan
        self._device_scan = None
        post = self._device_scan_postprocess()
        if post is not None:
            from ldpc_tpu_torch.ckt_noise.device_scan import (
                analyze_uniform_windows,
                make_device_owd,
            )

            uw = analyze_uniform_windows(
                self.dcm,
                self.decodings,
                self.window,
                self.commit,
                self.num_checks,
                self._get_weights(),
            )
            if uw is not None:
                cfg = getattr(self, "decoder_config", {})
                fn = make_device_owd(
                    uw,
                    self._min_weight,
                    max_iter=cfg.get("max_iter", 30),
                    bp_method=cfg.get("bp_method", "minimum_sum"),
                    # match the window decoders' constructor default
                    ms_scaling_factor=cfg.get("ms_scaling_factor", 1.0),
                    postprocess=post,
                    device=self.device,
                )
                self._device_scan = (uw, fn)
        if self._device_scan is None:
            # be loud (once) about the slow path: the device decoder only
            # exists for order-0 postprocessing on time-translation-
            # invariant DEMs (matching the reference OWD defaults,
            # ckt_noise/config.py:3-4); anything else runs the per-window
            # host loop, which is orders of magnitude slower on batches
            import warnings

            why = (
                "no device engine for this postprocess configuration"
                if post is None
                else "the DEM's windows are not time-translation invariant"
            )
            warnings.warn(
                f"{type(self).__name__}: overlapping-window decoding "
                f"falls back to the per-window host loop ({why}); large "
                "batches will be slow",
                RuntimeWarning,
                stacklevel=3,
            )
        return self._device_scan

    # -- decoding ----------------------------------------------------------
    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        """Decode one shot of detector data into observable predictions
        (reference: base_overlapping_window_decoder.py:66-87)."""
        corr = self._corr_multiple_rounds_batch(
            np.asarray(syndrome, dtype=np.uint8)[None, :].copy()
        )[0]
        return (self.logical_observables_matrix @ corr) % 2

    def _corr_multiple_rounds(self, syndrome: np.ndarray) -> np.ndarray:
        return self._corr_multiple_rounds_batch(
            np.atleast_2d(np.asarray(syndrome, dtype=np.uint8)).copy()
        )[0]

    def decode_batch(
        self,
        shots: np.ndarray,
        *,
        bit_packed_shots: bool = False,
        bit_packed_predictions: bool = False,
        return_corrections: bool = False,
    ):
        """Decode (num_shots, num_detectors) shots into observable
        predictions (reference: base_overlapping_window_decoder.py:141-176),
        batched per window.

        With ``return_corrections`` the call returns ``(predictions,
        corrections)``: the (num_shots, num_mechanisms) total correction of
        :meth:`_corr_multiple_rounds_batch`, uint8, or with
        ``bit_packed_predictions`` bit-packed little-endian along axis 1
        (``ceil(num_mechanisms / 8)`` bytes a shot) as the predictions are."""
        shots = np.asarray(shots)
        count("owd.shots", shots.shape[0])
        with span("owd.decode_batch", lanes=shots.shape[0]):
            if bit_packed_shots:
                shots = np.unpackbits(shots, axis=1, bitorder="little")[
                    :, : self.num_detectors
                ]
            corrs = self._corr_multiple_rounds_batch(
                shots.astype(np.uint8).copy()
            )
            with span("owd.predict"):
                predictions = (
                    (corrs @ np.asarray(self.logical_observables_matrix.todense()).T)
                    % 2
                ).astype(bool)
                if bit_packed_predictions:
                    predictions = np.packbits(predictions, axis=1, bitorder="little")
                    if return_corrections:
                        corrs = np.packbits(corrs, axis=1, bitorder="little")
        return (predictions, corrs) if return_corrections else predictions

    def _corr_multiple_rounds_batch(self, shots: np.ndarray) -> np.ndarray:
        """All shots of each window decode in one batched call
        (cf. the reference's per-shot loop,
        base_overlapping_window_decoder.py:178-225). When the DCM is
        time-translation invariant, the middle windows run on the device
        (ckt_noise/device_scan.py: the shots and the running correction go
        there once, and the correction comes back once) and only the two
        boundary windows take the host path."""
        num_shots = shots.shape[0]
        total_corr = np.zeros((num_shots, self.dcm.shape[1]), dtype=np.uint8)
        weights = self._get_weights().copy()
        scan = self._maybe_device_scan()
        pristine = shots.copy() if scan is not None else None

        decoding = 0
        while decoding < self.decodings:
            if scan is not None and decoding == scan[0].w_lo:
                uw, fn = scan
                # the device windows read the UNADJUSTED detector history
                # and recompute each window's committed-syndrome adjustment
                # from the running correction
                with span("owd.h2d"):
                    with sync("owd_shots_h2d"):
                        shots_dev = torch.from_numpy(pristine).to(self.device)
                    with sync("owd_corr_h2d"):
                        corr_dev = torch.from_numpy(total_corr).to(self.device)
                corr_dev = fn(shots_dev, corr_dev)
                with span("owd.d2h"):
                    with sync("owd_corr_d2h"):
                        total_corr = corr_dev.cpu().numpy().astype(np.uint8)
                # host bookkeeping for the remaining windows: scanned
                # commits pin their columns, and the resumed window's
                # rows are reconstructed from pristine shots + the full
                # running correction (exactly the value the host loop's
                # telescoping passes would have left there)
                with span("owd.bookkeeping"):
                    for w in range(uw.w_lo, uw.w_hi):
                        ci, _, _, _ = current_round_inds(
                            dcm=self.dcm,
                            decoding=w,
                            window=self.window,
                            commit=self.commit,
                            num_checks=self.num_checks,
                        )
                        weights[ci] = self._min_weight
                    _, _, _, si = current_round_inds(
                        dcm=self.dcm,
                        decoding=uw.w_hi - 1,
                        window=self.window,
                        commit=self.commit,
                        num_checks=self.num_checks,
                    )
                    rdcm = self.dcm[si, :]
                    shots[:, si] = pristine[:, si] ^ (
                        (total_corr @ rdcm.T) % 2
                    ).astype(shots.dtype)
                decoding = uw.w_hi
                continue
            count("owd.windows.host")
            with span("owd.window"):
                self._host_decode_window(
                    decoding, shots, total_corr, weights
                )
            decoding += 1
        return total_corr

    def _host_decode_window(self, decoding, shots, total_corr, weights):
        """One window of the host loop (mutates its array arguments)."""
        commit_inds, dec_inds, _, synd_dec_inds = current_round_inds(
            dcm=self.dcm,
            decoding=decoding,
            window=self.window,
            commit=self.commit,
            num_checks=self.num_checks,
        )
        round_dcm = self.dcm[synd_dec_inds, :]
        decoder = self._get_decoder(decoding, round_dcm, weights)

        window_shots = shots[:, synd_dec_inds].astype(np.uint8)
        if hasattr(decoder, "decode_batch"):
            corr = np.asarray(decoder.decode_batch(window_shots))
        else:
            corr = np.stack(
                [decoder.decode(s) for s in window_shots]
            ).astype(np.uint8)

        if decoding != self.decodings - 1:
            total_corr[:, commit_inds] += corr[:, commit_inds]
            shots[:, synd_dec_inds] ^= (
                (total_corr @ round_dcm.T) % 2
            ).astype(shots.dtype)
            weights[commit_inds] = self._min_weight
        else:
            total_corr[:, dec_inds] += corr[:, dec_inds]


def current_round_inds(
    dcm: csr_matrix,
    decoding: int,
    window: int,
    commit: int,
    num_checks: int,
) -> Tuple[slice, slice, slice, slice]:
    """Column/detector index ranges of one window
    (reference: base_overlapping_window_decoder.py:287-334)."""
    num_checks_decoding = num_checks * window
    num_checks_commit = num_checks * commit
    start = decoding * commit * num_checks
    end_commit = start + num_checks_commit
    end_decoding = start + num_checks_decoding

    min_index = dcm[slice(start, end_commit), :].nonzero()[1].min()
    max_index_commit = dcm[slice(start, end_commit), :].nonzero()[1].max()
    max_index_decoding = dcm[slice(start, end_decoding), :].nonzero()[1].max()

    commit_inds = slice(min_index, max_index_commit + 1)
    decoding_inds = slice(min_index, max_index_decoding + 1)
    synd_commit_inds = slice(start, end_commit)
    synd_decoding_inds = slice(start, end_decoding)
    return commit_inds, decoding_inds, synd_commit_inds, synd_decoding_inds
