"""Overlapping-window circuit-level decoding (port of
``ldpc_tpu.ckt_noise.base_overlapping_window_decoder``; reference:
src_python/ldpc/ckt_noise/base_overlapping_window_decoder.py).

The measurement-round ("sequence") axis is decoded in sliding windows:
each window's correction commits for the first ``commit`` rounds, the
committed correction's syndrome propagates forward, and committed
error mechanisms are re-weighted to certainty for later windows.

Batched: ``decode_batch`` feeds every shot of a window to the underlying
decoder in ONE call — the reference loops shot-by-shot in Python
(base_overlapping_window_decoder.py:210-218). Windows stay sequential
(their syndrome propagation is causal), shots don't. The decoders run on
``device`` (the CUDA device unless the caller passes ``device="cpu"``).
When the window decoders take device syndromes (``_decode_batch_device``,
as ``BpOsdDecoder`` and ``BpLsdDecoder`` do), a call keeps its state there
from input to output: the shots go up once (packed, if they came packed),
every window reads and updates the resident shots and running correction,
and only the predictions and corrections come back (packed, if asked).
When the DEM's windows are time-translation invariant the middle windows
of that call run through
:func:`ldpc_tpu_torch.ckt_noise.device_scan.make_device_owd`. Other window
decoders (PyMatching's) keep a plain numpy loop over the windows.

With the recorder of :mod:`ldpc_tpu_torch.utils.profiling` on, a
``decode_batch`` call is the root span ``owd.decode_batch`` (counter
``owd.shots``) over ``owd.h2d`` (the shots' upload), an ``owd.window`` a
loop window (counter ``owd.windows.host``; a boundary window's
``BpOsdDecoder`` nests its own ``decode_batch`` span in it), the device
windows' ``owd.scan`` (see ``device_scan``) and ``owd.bookkeeping`` (the
resumed window's rows), ``owd.predict`` and ``owd.d2h`` (the results'
copies: packed results cross in one). The counter
``owd.windows.resident`` counts the windows decoded on the resident state
and ``owd.d2h_bytes`` the bytes its results bring back.
The numpy loop has only ``owd.window`` and ``owd.predict``. Each host sync
of the OWD's own code is a ``sync.owd_<cause>`` span.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ldpc_tpu_torch.ckt_noise.dem_matrices import (
    detector_error_model_to_check_matrices,
)
from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops import gf2
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
        time-translation invariant (ckt_noise/device_scan.py); None
        decodes every window one by one."""
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

    # -- window plans -------------------------------------------------------
    def _plan(self, decoding: int) -> "_Window":
        """Window ``decoding``'s index ranges and detector rows, computed
        once (:func:`current_round_inds`)."""
        plans = self.__dict__.setdefault("_plans", {})
        if decoding not in plans:
            commit_inds, dec_inds, _, synd_dec_inds = current_round_inds(
                dcm=self.dcm,
                decoding=decoding,
                window=self.window,
                commit=self.commit,
                num_checks=self.num_checks,
            )
            plans[decoding] = _Window(
                commit_inds, dec_inds, synd_dec_inds, self.dcm[synd_dec_inds, :]
            )
        return plans[decoding]

    def _rows_table(self, key, rows) -> torch.Tensor:
        """``rows``' columns as a padded gather table on the device
        (:func:`device_scan.row_columns`), built once under ``key``. The
        pad is the index one past the last column, a zero column of the
        resident correction."""
        from ldpc_tpu_torch.ckt_noise.device_scan import row_columns

        tables = self.__dict__.setdefault("_tables", {})
        if key not in tables:
            table = row_columns(rows, self.dcm.shape[1])
            tables[key] = torch.from_numpy(table).to(self.device)
        return tables[key]

    def _resident(self) -> bool:
        """Whether a call keeps its state on the device: the window
        decoders take device syndromes (``_decode_batch_device``). Window
        0's decoder is built here as the first window would build it."""
        decoder = self._get_decoder(0, self._plan(0).round_dcm, self._get_weights())
        return hasattr(decoder, "_decode_batch_device")

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
        (``ceil(num_mechanisms / 8)`` bytes a shot) as the predictions are.

        When the window decoders take device syndromes the whole call runs
        on the device: only the shots go up (packed, if they came packed)
        and only the results come down (packed, if asked)."""
        shots = np.asarray(shots)
        count("owd.shots", shots.shape[0])
        with span("owd.decode_batch", lanes=shots.shape[0]):
            if self._resident():
                total = self._resident_corrections(self._upload(shots, bit_packed_shots))
                return self._download(
                    total, bit_packed_predictions, return_corrections
                )
            if bit_packed_shots:
                shots = np.unpackbits(shots, axis=1, bitorder="little")[
                    :, : self.num_detectors
                ]
            corrs = self._host_corrections(shots.astype(np.uint8).copy())
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
        base_overlapping_window_decoder.py:178-225); returns the
        (num_shots, num_mechanisms) uint8 total correction."""
        if self._resident():
            total = self._resident_corrections(self._upload(shots, False))
            return self._download(total, False, True)[1]
        return self._host_corrections(shots)

    # -- the resident path ---------------------------------------------------
    def _upload(self, shots: np.ndarray, bit_packed: bool) -> torch.Tensor:
        """The (B, num_detectors) uint8 shots on the device; packed shots
        go up packed and are unpacked there."""
        shots = np.asarray(shots)
        if shots.dtype not in (np.uint8, np.bool_):
            shots = shots.astype(np.uint8)
        with span("owd.h2d"):
            with sync("owd_shots_h2d"):
                dev = torch.from_numpy(np.ascontiguousarray(shots))
                dev = dev.to(self.device, copy=True)  # never the caller's memory
            if bit_packed:
                return gf2.unpack_bits_u8_device(dev, self.num_detectors)
            return dev.to(torch.uint8)

    def _resident_corrections(self, shots: torch.Tensor) -> torch.Tensor:
        """Every window of the call on device tensors, with the host loop's
        arithmetic: returns the (B, num_mechanisms + 1) uint8 total
        correction, its last column zero (the gather tables' pad). The
        middle windows go to ``make_device_owd`` when the DCM is
        time-translation invariant; the others decode through their
        decoder's ``_decode_batch_device``. Mutates ``shots``."""
        num_cols = self.dcm.shape[1]
        total = torch.zeros(
            (shots.shape[0], num_cols + 1), dtype=torch.uint8, device=shots.device
        )
        weights = self._get_weights().copy()
        scan = self._maybe_device_scan()
        pristine = shots.clone() if scan is not None else None

        decoding = 0
        while decoding < self.decodings:
            if scan is not None and decoding == scan[0].w_lo:
                uw, fn = scan
                # the device windows read the UNADJUSTED detector history
                # and recompute each window's committed-syndrome adjustment
                # from the running correction
                total[:, :num_cols] = fn(pristine, total[:, :num_cols])
                count("owd.windows.resident", uw.w_hi - uw.w_lo)
                # scanned commits pin their columns, and the resumed
                # window's rows are reconstructed from pristine shots + the
                # full running correction (exactly the value the host
                # loop's telescoping passes would have left there)
                with span("owd.bookkeeping"):
                    for w in range(uw.w_lo, uw.w_hi):
                        weights[self._plan(w).commit_inds] = self._min_weight
                    plan = self._plan(uw.w_hi - 1)
                    si = plan.synd_dec_inds
                    shots[:, si] = pristine[:, si] ^ _parity(
                        total, self._rows_table(("rows", uw.w_hi - 1), plan.round_dcm)
                    )
                decoding = uw.w_hi
                continue
            count("owd.windows.host")
            count("owd.windows.resident")
            with span("owd.window"):
                self._resident_window(decoding, shots, total, weights)
            decoding += 1
        return total

    def _resident_window(self, decoding, shots, total, weights):
        """One window of the loop on device tensors (mutates its tensor
        arguments and ``weights``): the host loop's ``+=`` commits and its
        XOR of the syndrome rows with the running correction's parity."""
        plan = self._plan(decoding)
        decoder = self._get_decoder(decoding, plan.round_dcm, weights)
        rows = plan.synd_dec_inds
        corr = decoder._decode_batch_device(shots[:, rows].contiguous())
        if decoding != self.decodings - 1:
            total[:, plan.commit_inds] += corr[:, plan.commit_inds]
            shots[:, rows] ^= _parity(
                total, self._rows_table(("rows", decoding), plan.round_dcm)
            )
            weights[plan.commit_inds] = self._min_weight
        else:
            total[:, plan.dec_inds] += corr[:, plan.dec_inds]

    def _download(self, total, bit_packed: bool, return_corrections: bool):
        """The predictions (the parity of the total correction on each
        observable's columns) and, when asked, the corrections, packed on
        the device when asked, then copied to the host: packed, both in one
        copy, split on the host into contiguous arrays. Packing takes
        nonzero as 1, as ``np.packbits`` does; unpacked corrections keep
        their values."""
        with span("owd.predict"):
            obs = self._rows_table("observables", self.logical_observables_matrix)
            predictions = _parity(total, obs).to(torch.bool)
            corrs = total[:, :-1]
            if bit_packed:
                predictions = gf2.pack_bits_u8(predictions)
                if return_corrections:
                    both = torch.cat([predictions, gf2.pack_bits_u8(corrs != 0)], dim=1)
            elif return_corrections:
                corrs = corrs.contiguous()
        with span("owd.d2h"):
            if bit_packed and return_corrections:
                with sync("owd_results_d2h"):
                    both = both.cpu().numpy()
                width = predictions.shape[1]
                predictions = np.ascontiguousarray(both[:, :width])
                corrs = np.ascontiguousarray(both[:, width:])
            else:
                with sync("owd_predictions_d2h"):
                    predictions = predictions.cpu().numpy()
                if return_corrections:
                    with sync("owd_corr_d2h"):
                        corrs = corrs.cpu().numpy()
        count("owd.d2h_bytes", predictions.nbytes + (corrs.nbytes if return_corrections else 0))
        return (predictions, corrs) if return_corrections else predictions

    # -- the host loop ---------------------------------------------------------
    def _host_corrections(self, shots: np.ndarray) -> np.ndarray:
        """The windows one after another as numpy arrays, for window
        decoders that take host syndromes only (mutates ``shots``)."""
        total_corr = np.zeros((shots.shape[0], self.dcm.shape[1]), dtype=np.uint8)
        weights = self._get_weights().copy()
        for decoding in range(self.decodings):
            count("owd.windows.host")
            with span("owd.window"):
                self._host_decode_window(decoding, shots, total_corr, weights)
        return total_corr

    def _host_decode_window(self, decoding, shots, total_corr, weights):
        """One window of the host loop (mutates its array arguments)."""
        plan = self._plan(decoding)
        commit_inds, dec_inds = plan.commit_inds, plan.dec_inds
        synd_dec_inds, round_dcm = plan.synd_dec_inds, plan.round_dcm
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


class _Window(NamedTuple):
    """A window's column ranges, detector rows and their check matrix."""

    commit_inds: slice
    dec_inds: slice
    synd_dec_inds: slice
    round_dcm: csr_matrix


def _parity(total: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, R) uint8: each table row's parity of ``total``'s values on its
    columns, an exact integer sum & 1 (``(total @ rows.T) % 2``)."""
    return (total[:, table].sum(dim=2, dtype=torch.int32) & 1).to(torch.uint8)


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
