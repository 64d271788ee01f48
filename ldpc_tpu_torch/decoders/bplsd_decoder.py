"""BpLsdDecoder: BP with localized-statistics-decoding fallback.

Port of ``ldpc_tpu.decoders.bplsd_decoder.BpLsdDecoder`` (reference:
src_python/ldpc/bplsd_decoder/_bplsd_decoder.pyx): BP first, on
non-convergence LSD guided by the BP posterior LLRs
(_bplsd_decoder.pyx:144-155); ``lsd_method``/``lsd_order`` accept the
``osd_method``/``osd_order`` compatibility kwargs (:69-78);
``always_run_lsd`` runs LSD on every nonzero syndrome. ``decode_batch``
runs the two-phase BP cascade of :meth:`BpDecoderBase._decode_cascade`
and :func:`ldpc_tpu_torch.ops.lsd.make_lsd_decoder` on the lanes
full-depth BP fails (kernels K4' and, above order 0, K5').
``set_do_stats(True)`` records the per-cluster growth statistics of one row
(:func:`ldpc_tpu_torch.decoders.lsd_stats.compute_lsd_statistics`).
"""

import time
import warnings
from typing import List, Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.decoders.base import BpDecoderBase, _to_numpy
from ldpc_tpu_torch.decoders.lsd_common import (
    METHOD_NAMES,
    Statistics,
    parse_lsd_method,
)
from ldpc_tpu_torch.decoders.lsd_stats import compute_lsd_statistics
from ldpc_tpu_torch.ops import gf2
from ldpc_tpu_torch.ops import lsd as lsd_ops
from ldpc_tpu_torch.ops.pcm import graph_to_torch
from ldpc_tpu_torch.utils.profiling import sync


class BpLsdDecoder(BpDecoderBase):
    """BP + LSD decoder, batched (arXiv:2406.18655).

    Parameters mirror ``ldpc_tpu.BpLsdDecoder``: the BP parameters of
    :class:`~ldpc_tpu_torch.BpDecoder`, ``bits_per_step`` (bits a cluster
    admits per growth round; 0 = all of its boundary), ``lsd_method``
    ('LSD_0' | 'LSD_E' | 'LSD_CS' plus the reference's aliases),
    ``lsd_order``, ``always_run_lsd``; plus ``device``, where the
    decoder's tensors live.
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
        bits_per_step: int = 1,
        input_vector_type: str = "syndrome",
        lsd_order: int = 0,
        lsd_method: Union[str, int] = 0,
        always_run_lsd: bool = False,
        device="cuda",
        **kwargs,
    ):
        # osd_method / osd_order compatibility (_bplsd_decoder.pyx:69-78)
        if "osd_method" in kwargs:
            lsd_method = kwargs.pop("osd_method")
        if "osd_order" in kwargs:
            lsd_order = kwargs.pop("osd_order")
        if lsd_order < 0:
            raise ValueError(
                f"lsd_order must be greater than or equal to 0. Not {lsd_order}."
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
            device=device,
            **kwargs,
        )
        self._lsd_method = 0
        self._lsd_order = 0
        self.lsd_method = lsd_method
        self.lsd_order = lsd_order
        self.always_run_lsd = always_run_lsd
        self.bits_per_step = bits_per_step if bits_per_step != 0 else self.n
        self._do_stats = False
        self._stats_row = 0
        self._statistics = Statistics()
        self._lsd_fn = None
        self._bp_decoding = np.zeros(self.n, dtype=np.uint8)

    # ------------------------------------------------------------------
    @property
    def lsd_method(self) -> Optional[str]:
        return METHOD_NAMES.get(self._lsd_method)

    @lsd_method.setter
    def lsd_method(self, method: Union[str, int, float]) -> None:
        self._lsd_method = parse_lsd_method(method)
        if self._lsd_method == lsd_ops.LSD_0:
            self._lsd_order = 0
        self._lsd_fn = None

    @property
    def lsd_order(self) -> int:
        return self._lsd_order

    @lsd_order.setter
    def lsd_order(self, order: int) -> None:
        if order < 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. Please choose a "
                "positive integer."
            )
        if self._lsd_method == lsd_ops.LSD_0 and order != 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. The 'osd_method' is "
                "set to 'OSD_0'. The osd order must therefore be set to 0."
            )
        if self._lsd_method == lsd_ops.LSD_E and order > 15:
            warnings.warn(
                "WARNING: Running the 'OSD_E' (Exhaustive method) with "
                "search depth greater than 15 is not recommended. Use the "
                "'osd_cs' method instead."
            )
        self._lsd_order = order
        self._lsd_fn = None

    # ------------------------------------------------------------------
    # statistics plumbing (reference: _bplsd_decoder.pyx:174-321)
    # ------------------------------------------------------------------
    @property
    def statistics(self) -> Statistics:
        return self._statistics

    @property
    def do_stats(self) -> bool:
        return self._do_stats

    def set_do_stats(self, value: bool, row: int = 0) -> None:
        """Enable statistics collection for batch row ``row`` of later
        decodes: a decode whose LSD stage runs on that row replays its
        growth and records it."""
        self._do_stats = bool(value)
        if row < 0:
            raise ValueError(f"stats row must be >= 0, not {row}")
        self._stats_row = int(row)

    @property
    def stats_row(self) -> int:
        """The batch row the next decode's statistics will describe."""
        return self._stats_row

    def set_additional_stat_fields(self, error, syndrome, compare_recover):
        self._statistics.error = list(np.asarray(error).astype(int))
        self._statistics.syndrome = list(np.asarray(syndrome).astype(int))
        self._statistics.compare_recover = list(
            np.asarray(compare_recover).astype(int)
        )

    def reset_cluster_stats(self) -> None:
        self._statistics = Statistics()

    # ------------------------------------------------------------------
    def _lsd_decode_fn(self):
        if self._lsd_fn is None:
            self._lsd_fn = lsd_ops.make_lsd_decoder(
                self.graph,
                lsd_method=max(self._lsd_method, 0),
                lsd_order=self._lsd_order,
                bits_per_step=self.bits_per_step,
                device=self._device,
            )
        return self._lsd_fn

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
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
        """Decode a (B, m) batch: BP, then LSD on the lanes full-depth BP
        failed (on every nonzero lane when ``always_run_lsd``).

        ``bit_packed_syndromes`` accepts little-endian bit-packed input
        (``(B, ceil(m/8))`` uint8, stim b8 layout) and
        ``bit_packed_output`` returns ``(B, ceil(n/8))`` packed decodings.
        """
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        t0 = time.perf_counter()
        with sync("syndromes_h2d"):
            syn = torch.from_numpy(syndromes).to(self._device)
        out = self._decode_batch_device(syn)
        self._bp_decoding = _to_numpy(self._bp_batch[0])
        result = _to_numpy(gf2.pack_bits_u8(out) if bit_packed_output else out)
        self._decoding = _to_numpy(out[0])

        # the LSD result is live for the stats row iff BP did not converge
        # there, or always_run_lsd forces the LSD stage
        r = min(self._stats_row, syndromes.shape[0] - 1)
        lsd_ran = bool(syndromes[r].any()) and (
            self.always_run_lsd or not bool(self.converge_batch[r])
        )
        self._statistics.clear()
        if lsd_ran and self._do_stats:
            # the stats row's LSD decode, replayed with the decoder's own
            # growth primitives on its device (lsd.hpp:652-816 semantics)
            llr_r = _to_numpy(self._llr_batch[r])
            self._statistics.stats_row = r
            self._statistics.bit_llrs = list(map(float, llr_r))
            self._statistics.syndrome = list(map(int, syndromes[r]))
            compute_lsd_statistics(
                graph_to_torch(self.graph, self._device),
                self.graph.dense,
                syndromes[r],
                llr_r,
                self.bits_per_step,
                _to_numpy(out[r]),
                stats=self._statistics,
            )
        self._statistics.elapsed_time = (time.perf_counter() - t0) * 1e6
        self._statistics.lsd_order = self._lsd_order
        # stats carry the reference's OsdMethod enum value, where
        # OSD_OFF=0 and OSD_0=1 (osd.hpp:18-23)
        self._statistics.lsd_method = max(self._lsd_method, -1) + 1
        return result

    def _decode_batch_device(self, syndromes: torch.Tensor) -> torch.Tensor:
        """``decode_batch`` on (B, m) uint8 syndromes on the decoder's
        device: the (B, n) uint8 decodings stay there; of the batch only the
        stored flags and iteration counts come to the host. The single-row
        properties and the statistics are not updated."""
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). "
                f"Not {tuple(syndromes.shape)}."
            )
        lsd_fn = self._lsd_decode_fn()

        def post_fn(syn_f, llr_f):
            return (lsd_fn(syn_f, llr_f)[0],)

        if self.always_run_lsd:
            return self._decode_always(syndromes, post_fn)
        return self._decode_cascade_device(syndromes, post_fn)[0]

    def _decode_always(self, syn: torch.Tensor, post_fn) -> torch.Tensor:
        """One full-depth BP run on (B, m) device syndromes, then
        ``post_fn`` on every nonzero lane."""
        nonzero = (syn != 0).any(dim=1)
        bp = self._run_bp_batch(syn)
        out = bp.decoding * nonzero[:, None].to(bp.decoding.dtype)
        lanes = torch.nonzero(nonzero).squeeze(1)  # host sync
        if lanes.numel():
            (dec,) = post_fn(syn[lanes], bp.llr_posterior[lanes])
            out = out.index_put((lanes,), dec.to(out.dtype))
        self._store_batch(bp.converged | ~nonzero, bp.iterations, bp.llr_posterior, bp.decoding)
        return out

    @property
    def bp_decoding(self) -> np.ndarray:
        return np.asarray(self._bp_decoding).astype(int)
