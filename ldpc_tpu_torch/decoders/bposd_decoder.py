"""BpOsdDecoder and SoftInfoBpOsdDecoder: belief propagation +
ordered-statistics fallback.

Port of ``ldpc_tpu.decoders.bposd_decoder`` for OSD-0, OSD-E, OSD-CS and
OSD off. ``BpOsdDecoder.decode_batch`` runs the BP of
:meth:`BpDecoderBase._decode_cascade` (two phases for parallel float32, one
full-depth run otherwise) and OSD on the lanes full-depth BP fails, in the
decoder's dtype: kernel K2' at order 0, kernel K3' and the candidate sweep
of :mod:`ldpc_tpu_torch.ops.osd` above it.
"""

import warnings
from typing import List, Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.decoders.base import BpDecoderBase, _to_numpy
from ldpc_tpu_torch.decoders.bp_decoder import SoftInfoBpDecoder
from ldpc_tpu_torch.ops import gf2
from ldpc_tpu_torch.ops import osd as osd_ops
from ldpc_tpu_torch.utils.profiling import count, span, sync

_METHOD_NAMES = {
    osd_ops.OSD_0: "OSD_0",
    osd_ops.EXHAUSTIVE: "OSD_E",
    osd_ops.COMBINATION_SWEEP: "OSD_CS",
    osd_ops.OSD_OFF: "OSD_OFF",
}


class BpOsdDecoder(BpDecoderBase):
    """BP decoding with OSD post-processing (batched).

    Runs belief propagation first; on non-convergence falls back to
    ordered-statistics decoding guided by the BP posterior LLRs.
    ``osd_method`` is one of 'OSD_0' | 'OSD_E' | 'OSD_CS' | 'OSD_OFF' (plus
    the reference's aliases) and ``osd_order`` the search depth of OSD-E
    and OSD-CS. ``device`` is where the decoder's tensors live.
    """

    def __init__(
        self,
        pcm: Union[np.ndarray, scipy.sparse.spmatrix],
        error_rate: Optional[float] = None,
        error_channel: Optional[Union[np.ndarray, List[float]]] = None,
        max_iter: Optional[int] = 0,
        bp_method: Optional[str] = "minimum_sum",
        ms_scaling_factor: Optional[Union[float, int]] = 1.0,
        schedule: Optional[str] = "parallel",
        omp_thread_count: Optional[int] = 1,
        random_schedule_seed: Optional[int] = 0,
        serial_schedule_order: Optional[List[int]] = None,
        osd_method: Union[str, int, float] = 0,
        osd_order: int = 0,
        input_vector_type: str = "syndrome",
        random_serial_schedule: bool = False,
        device="cuda",
        **kwargs,
    ):
        for key in kwargs.keys():
            if key not in ("channel_probs", "dtype"):
                raise ValueError(
                    f"Unknown parameter '{key}' passed to the BpDecoder constructor."
                )
        super().__init__(
            pcm,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=max_iter,
            bp_method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            schedule=schedule,
            omp_thread_count=omp_thread_count,
            random_schedule_seed=random_schedule_seed,
            serial_schedule_order=serial_schedule_order,
            random_serial_schedule=random_serial_schedule,
            device=device,
            **kwargs,
        )
        self.input_vector_type = input_vector_type
        self._osd_method = 0
        self._osd_order = 0
        self.osd_method = osd_method
        self.osd_order = osd_order
        self._osdw_decoding = np.zeros(self.n, dtype=np.uint8)
        self._bp_decoding = np.zeros(self.n, dtype=np.uint8)
        self._osd0_batch = None  # device tensors, pulled on property access
        self._osdw_batch = None

    # ------------------------------------------------------------------
    # OSD configuration
    # ------------------------------------------------------------------
    @property
    def osd_method(self) -> Optional[str]:
        return _METHOD_NAMES[self._osd_method]

    @osd_method.setter
    def osd_method(self, method: Union[str, int, float]) -> None:
        sval = str(method).lower()
        if sval in ("osd_0", "0", "osd0"):
            self._osd_method = osd_ops.OSD_0
            self._osd_order = 0
        elif sval in ("osd_e", "e", "exhaustive"):
            self._osd_method = osd_ops.EXHAUSTIVE
        elif sval in ("osd_cs", "1", "cs", "combination_sweep"):
            self._osd_method = osd_ops.COMBINATION_SWEEP
        elif sval in ("off", "osd_off", "deactivated", "-1"):
            self._osd_method = osd_ops.OSD_OFF
        else:
            raise ValueError(
                f"ERROR: OSD method '{method}' invalid. Please choose from "
                "the following methods: 'OSD_0', 'OSD_E' or 'OSD_CS'."
            )
        self._invalidate_osd()

    @property
    def osd_order(self) -> int:
        return self._osd_order

    @osd_order.setter
    def osd_order(self, order: int) -> None:
        if order < 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. Please choose a "
                "positive integer."
            )
        if self._osd_method == osd_ops.OSD_0 and order != 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. The 'osd_method' is "
                "set to 'OSD_0'. The osd order must therefore be set to 0."
            )
        if self._osd_method == osd_ops.EXHAUSTIVE and order > 15:
            warnings.warn(
                "WARNING: Running the 'OSD_E' (Exhaustive method) with "
                "search depth greater than 15 is not recommended. Use the "
                "'osd_cs' method instead."
            )
        self._osd_order = order
        self._invalidate_osd()

    def _invalidate_osd(self):
        for key in [k for k in self._decoder_cache if k and k[0] == "osd"]:
            del self._decoder_cache[key]

    def _osd_decode_fn(self):
        key = ("osd", self._osd_method, self._osd_order, tuple(self._channel))
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = osd_ops.make_osd_decoder(
                self.graph,
                self._channel,
                self._osd_method,
                self._osd_order,
                self._device,
                dtype=self._dtype,
            )
            self._decoder_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # decoding
    # ------------------------------------------------------------------
    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        """BP decode; on non-convergence fall back to OSD."""
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    def decode_batch(
        self,
        syndromes: np.ndarray,
        *,
        bit_packed_syndromes: bool = False,
        bit_packed_output: bool = False,
    ) -> np.ndarray:
        """Decode a (B, m) batch: the two-phase BP cascade, then OSD on the
        lanes full-depth BP failed.

        ``bit_packed_syndromes`` accepts little-endian bit-packed input
        (``(B, ceil(m/8))`` uint8, stim b8 layout) and
        ``bit_packed_output`` returns ``(B, ceil(n/8))`` packed decodings.

        With the recorder on (:mod:`ldpc_tpu_torch.utils.profiling`) a call
        is one root span, ``decode_batch``, over the cascade's spans, the
        post-processor's ``osd`` and ``decoder.d2h``.
        """
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        return self._decode_batch(syndromes, bit_packed_output)

    def _decode_batch_device(self, syndromes: torch.Tensor) -> torch.Tensor:
        """``decode_batch`` on (B, m) uint8 syndromes on the decoder's
        device: the (B, n) uint8 decodings stay there; of the batch only the
        stored flags and iteration counts come to the host. The single-row
        properties (``decoding``, ``bp_decoding``) are not updated."""
        return self._decode_batch(syndromes, None)

    def _decode_batch(self, syndromes, bit_packed_output: Optional[bool]):
        """Both entries' call: a numpy batch is copied to the device first
        (``_decode_cascade``), a device batch is decoded where it is; with
        ``bit_packed_output`` None the device decodings are returned."""
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). "
                f"Not {tuple(syndromes.shape)}."
            )
        count("lanes.in", syndromes.shape[0])
        with span("decode_batch", lanes=syndromes.shape[0]):
            post_fn = None
            if self._osd_method != osd_ops.OSD_OFF:
                osd_fn = self._osd_decode_fn()

                def post_fn(syn_f, llr_f):
                    osd0, osdw, _ = osd_fn(syn_f, llr_f)
                    return osd0, osdw

            if isinstance(syndromes, torch.Tensor):
                outs = self._decode_cascade_device(syndromes, post_fn)
            else:
                outs = self._decode_cascade(syndromes, post_fn)
            self._osd0_batch, out = outs[0], outs[-1]
            self._osdw_batch = out
            if bit_packed_output is None:
                return out
            with span("decoder.d2h"):
                with sync("bp_row0"):
                    self._bp_decoding = _to_numpy(self._bp_batch[0])
                if bit_packed_output:
                    with sync("output"):
                        packed = _to_numpy(gf2.pack_bits_u8(out))
                    row0 = gf2.unpack_bits_u8(packed[:1], self.n)[0]
                    result = packed
                else:
                    with sync("output"):
                        result = _to_numpy(out)
                    row0 = result[0]
            self._osdw_decoding = row0
            self._decoding = row0
            return result

    # ------------------------------------------------------------------
    # result properties
    # ------------------------------------------------------------------
    @property
    def bp_decoding_batch(self) -> Optional[np.ndarray]:
        """Full-depth BP decodings of the last batch."""
        return None if self._bp_batch is None else _to_numpy(self._bp_batch)

    @property
    def osd0_decoding_batch(self) -> Optional[np.ndarray]:
        """OSD-0 decodings of the last batch (BP's where BP converged)."""
        return None if self._osd0_batch is None else _to_numpy(self._osd0_batch)

    @property
    def osdw_decoding_batch(self) -> Optional[np.ndarray]:
        """OSD-w decodings of the last batch; at order 0 equal to OSD-0's."""
        return None if self._osdw_batch is None else _to_numpy(self._osdw_batch)

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)

    @property
    def bp_decoding(self) -> np.ndarray:
        return np.asarray(self._bp_decoding).astype(int)

    @property
    def osd0_decoding(self) -> np.ndarray:
        if self._converge:
            return self.bp_decoding
        return _to_numpy(self._osd0_batch[0]).astype(int)

    @property
    def osdw_decoding(self) -> np.ndarray:
        if self._converge:
            return self.bp_decoding
        return np.asarray(self._osdw_decoding).astype(int)


class SoftInfoBpOsdDecoder(SoftInfoBpDecoder):
    """Soft-syndrome BP with an OSD fallback.

    Serial min-sum soft-info BP (arXiv:2205.02341, kernel K7'); on the
    lanes that do not converge the final soft syndrome is hardened (value
    <= 0 -> 1) and OSD runs on it, guided by the BP posteriors.
    """

    def __init__(
        self,
        pcm: Union[np.ndarray, scipy.sparse.spmatrix],
        error_rate: Optional[float] = None,
        error_channel: Optional[List[float]] = None,
        max_iter: Optional[int] = 0,
        ms_scaling_factor: Optional[float] = 1.0,
        osd_method: Union[str, int, float] = 0,
        osd_order: int = 0,
        cutoff: Optional[float] = np.inf,
        sigma: float = 2.0,
        device="cuda",
        **kwargs,
    ):
        super().__init__(
            pcm,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor,
            cutoff=cutoff,
            sigma=sigma,
            device=device,
            **kwargs,
        )
        self._osd_method = 0
        self._osd_order = 0
        self.osd_method = osd_method
        self.osd_order = osd_order

    osd_method = BpOsdDecoder.osd_method
    osd_order = BpOsdDecoder.osd_order
    _invalidate_osd = BpOsdDecoder._invalidate_osd
    _osd_decode_fn = BpOsdDecoder._osd_decode_fn

    def decode_batch(self, soft_syndromes: np.ndarray) -> np.ndarray:
        bp_out = super().decode_batch(soft_syndromes)
        conv = self.converge_batch
        if conv.all() or self._osd_method == osd_ops.OSD_OFF:
            return bp_out
        failed = torch.from_numpy(np.flatnonzero(~conv)).to(self._device)
        # harden where K7' left the soft syndromes: on the card
        soft = torch.as_tensor(self._soft_out, device=self._device)
        hard = (soft[failed] <= 0).to(torch.uint8)
        _, osdw, _ = self._osd_decode_fn()(hard, self._llr_batch[failed])
        out = bp_out.copy()
        out[failed.cpu().numpy()] = _to_numpy(osdw)
        self._decoding = out[0]
        return out
