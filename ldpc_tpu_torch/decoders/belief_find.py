"""BeliefFindDecoder: BP with a union-find fallback guided by BP LLRs.

Port of ``ldpc_tpu.decoders.belief_find.BeliefFindDecoder`` (reference:
src_python/ldpc/belief_find_decoder/_belief_find_decoder.pyx): BP runs
first; on the lanes it fails, the union-find decoder grows clusters guided
by the BP posterior LLRs (arXiv:1709.06218, arXiv:2103.08049).
``uf_method`` is 'peeling' (default, column degree <= 2 only) or
'inversion' (_belief_find_decoder.pyx:62-71). ``decode_batch`` is the
two-phase BP cascade of :meth:`BpDecoderBase._decode_cascade` with
:func:`ldpc_tpu_torch.ops.uf.make_uf_decoder` or ``make_peel_decoder``
(kernel K4') on the lanes full-depth BP fails.
"""

from typing import List, Optional, Union

import numpy as np
import scipy.sparse

from ldpc_tpu_torch.decoders.base import BpDecoderBase, _to_numpy
from ldpc_tpu_torch.ops import gf2
from ldpc_tpu_torch.ops import uf as uf_ops


class BeliefFindDecoder(BpDecoderBase):
    """BP + union-find (BeliefFind) decoder, batched.

    Parameters mirror ``ldpc_tpu.BeliefFindDecoder``: the BP parameters of
    :class:`~ldpc_tpu_torch.BpDecoder`, ``uf_method`` and ``bits_per_step``
    (bits a cluster admits per growth round; 0 = all of its boundary); plus
    ``device``, where the decoder's tensors live.
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
        uf_method: str = "peeling",
        bits_per_step: int = 0,
        input_vector_type: str = "syndrome",
        device="cuda",
        **kwargs,
    ):
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
        self.uf_method = uf_method  # validates and checks column degrees
        self.bits_per_step = bits_per_step if bits_per_step != 0 else self.n
        self._uf_fn = None

    @property
    def uf_method(self) -> str:
        return self._uf_method

    @uf_method.setter
    def uf_method(self, value: str) -> None:
        sval = str(value).lower()
        if sval in ("inversion", "invert", "matrix"):
            self._uf_method = "inversion"
        elif sval in ("peeling", "peel"):
            col_deg = np.asarray((self._pcm != 0).sum(axis=0)).ravel()
            bad = np.flatnonzero(col_deg > 2)
            if bad.size:
                raise ValueError(
                    "The 'peeling' method is only suitable for LDPC codes "
                    "with point like syndromes. Each column of the PCM must "
                    f"have at most 2 entries. Column {bad[0]} has degree "
                    f"{col_deg[bad[0]]}."
                )
            self._uf_method = "peeling"
        else:
            raise ValueError(
                f"Invalid UF method: {value}. Must be one of 'inversion' "
                "or 'peeling'."
            )
        self._uf_fn = None

    def _uf_decode_fn(self):
        if self._uf_fn is None:
            maker = (
                uf_ops.make_uf_decoder
                if self._uf_method == "inversion"
                else uf_ops.make_peel_decoder
            )
            self._uf_fn = maker(
                self.graph, bits_per_step=self.bits_per_step, device=self._device
            )
        return self._uf_fn

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
        """Decode a (B, m) batch: BP, then union-find on the lanes full-depth
        BP failed (the reference decodes its UF fallback one syndrome at a
        time: _belief_find_decoder.pyx:125-136).

        ``bit_packed_syndromes`` accepts little-endian bit-packed input
        (``(B, ceil(m/8))`` uint8, stim b8 layout) and
        ``bit_packed_output`` returns ``(B, ceil(n/8))`` packed decodings.
        """
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). "
                f"Not {syndromes.shape}."
            )
        uf_fn = self._uf_decode_fn()
        out = self._decode_cascade(syndromes, lambda s, l: (uf_fn(s, l)[0],))[0]
        self._decoding = _to_numpy(out[0])
        return _to_numpy(gf2.pack_bits_u8(out) if bit_packed_output else out)
