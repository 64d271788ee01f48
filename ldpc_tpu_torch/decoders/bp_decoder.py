"""BpDecoder and SoftInfoBpDecoder (port of ``ldpc_tpu.decoders.bp_decoder``)."""

from typing import List, Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.decoders.base import (
    BpDecoderBase,
    _AUTO,
    _RECEIVED_VECTOR,
    _SYNDROME,
    _to_numpy,
)
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.ops import gf2


class BpDecoder(BpDecoderBase):
    """Belief propagation decoder for binary linear codes (batched).

    Parameters mirror ``ldpc_tpu.BpDecoder``: ``pcm``, ``error_rate``,
    ``error_channel``, ``max_iter`` (0 = block length), ``bp_method``
    ('product_sum'/'minimum_sum' + aliases), ``ms_scaling_factor``
    (0.0 = dynamic 1-2^-iter), ``schedule``
    ('parallel'/'serial'/'serial_relative' + aliases), ``omp_thread_count``
    (unused), ``random_schedule_seed``, ``serial_schedule_order``,
    ``input_vector_type``, ``random_serial_schedule``, ``dtype`` (float32,
    or float64 for the fold-exact engines); plus ``device``, where the
    decoder's tensors live: ``"cuda"`` by default, ``"cpu"`` runs the
    kernels' plain versions.
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
        input_vector_type: str = "auto",
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

    def decode(self, input_vector: np.ndarray) -> np.ndarray:
        """Decode one syndrome (length m) or received vector (length n).

        Zero inputs short-circuit to the all-zero decoding with
        ``converge=True``.
        """
        input_vector = np.asarray(input_vector)
        length = len(input_vector)
        if self._input_vector_type == _SYNDROME and length != self.m:
            raise ValueError(
                f"The input_vector must have length {self.m} (for syndrome "
                f"decoding). Not length {length}."
            )
        if self._input_vector_type == _RECEIVED_VECTOR and length != self.n:
            raise ValueError(
                f"The input_vector must have length {self.n} (for received "
                f"vector decoding). Not length {length}."
            )
        if self._input_vector_type == _AUTO and length not in (self.m, self.n):
            raise ValueError(
                f"The input_vector must have length {self.m} (for syndrome "
                f"decoding) or length {self.n} (for received vector decoding). "
                f"Not length {length}."
            )
        dtype = input_vector.dtype

        if not input_vector.any():
            self._converge = True
            return np.zeros(self.n, dtype=dtype)

        as_syndrome = self._input_vector_type == _SYNDROME or (
            self._input_vector_type == _AUTO and length == self.m
        )
        if as_syndrome:
            result = self._run_bp_batch(input_vector[None, :].astype(np.uint8))
            self._store_single_result(result)
            return self._decoding.astype(dtype)

        # received-vector mode: decode the vector's syndrome, then XOR the
        # BP decoding back onto the received vector
        rv = input_vector.astype(np.uint8) % 2
        syndrome = (self.pcm @ rv) % 2
        result = self._run_bp_batch(syndrome[None, :].astype(np.uint8))
        self._store_single_result(result)
        self._decoding = (self._decoding ^ rv).astype(np.uint8)
        return self._decoding.astype(dtype)

    def decode_batch(
        self,
        syndromes: np.ndarray,
        *,
        bit_packed_syndromes: bool = False,
        bit_packed_output: bool = False,
    ) -> np.ndarray:
        """Decode a (B, m) batch of syndromes with one full-depth BP run.

        Returns the (B, n) decodings; per-element results are exposed as
        ``converge_batch``, ``iter_batch`` and ``log_prob_ratios_batch``.
        ``bit_packed_syndromes``/``bit_packed_output`` take/return
        little-endian bit-packed rows (stim b8 layout).
        """
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). Not {syndromes.shape}."
            )
        result = self._run_bp_batch(syndromes)
        self.converge_batch = _to_numpy(result.converged)
        self.iter_batch = _to_numpy(result.iterations)
        self._llr_batch = result.llr_posterior
        self._converge = bool(self.converge_batch[0])
        self._iter = int(self.iter_batch[0])
        self._log_prob_ratios = _to_numpy(result.llr_posterior[0])
        if bit_packed_output:
            return _to_numpy(gf2.pack_bits_u8(result.decoding))
        return _to_numpy(result.decoding)

    def _single_scan_fn(self):
        key = ("single_scan", self._max_iter, float(self._ms_scaling_factor), self._dtype)
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = bp_ops.make_single_scan_decoder(
                self.graph, self._max_iter, self._ms_scaling_factor, self._device,
                dtype=self._dtype,
            )
            self._decoder_cache[key] = fn
        return fn

    def decode_single_scan(self, syndrome: np.ndarray) -> np.ndarray:
        """Min-sum single-scan BP decode of one syndrome. Ignores
        ``bp_method`` and ``schedule``: single-scan is min-sum with the
        fixed ``ms_scaling_factor`` by construction. float32 only."""
        syndrome = np.asarray(syndrome)
        if len(syndrome) != self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        dtype = syndrome.dtype
        if not syndrome.any():
            self._converge = True
            return np.zeros(self.n, dtype=dtype)
        result = self._single_scan_fn()(syndrome[None, :].astype(np.uint8), self._init_llr())
        self._store_single_result(result)
        return self._decoding.astype(dtype)


class SoftInfoBpDecoder(BpDecoderBase):
    """Soft-syndrome min-sum BP decoder (arXiv:2205.02341).

    Accounts for uncertainty in the syndrome readout with a serial schedule
    and virtual syndrome-update rules below the ``cutoff`` magnitude; the
    soft syndromes are log-likelihoods scaled by 2/sigma^2 (kernel K7').
    ``device`` is where the decoder's tensors live.
    """

    def __init__(
        self,
        pcm: Union[np.ndarray, scipy.sparse.spmatrix],
        error_rate: Optional[float] = None,
        error_channel: Optional[List[float]] = None,
        max_iter: Optional[int] = 0,
        bp_method: Optional[str] = "minimum_sum",
        ms_scaling_factor: Optional[float] = 1.0,
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
            bp_method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            device=device,
            **kwargs,
        )
        self.cutoff = cutoff
        if not isinstance(sigma, float) or sigma <= 0:
            raise ValueError("The sigma value must be a float greater than 0.")
        self.sigma = sigma
        self.schedule = "serial"
        self.bp_method = "minimum_sum"
        self.input_vector_type = "syndrome"
        self._soft_syndrome = np.zeros(self.m)
        self._soft_out = None  # the last batch's final soft syndromes

    def _soft_decode_fn(self):
        key = ("soft", self._max_iter, float(self._ms_scaling_factor), self._dtype)
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = bp_ops.make_soft_info_decoder(
                self.graph, self._max_iter, self._ms_scaling_factor, self._device,
                dtype=self._dtype,
            )
            self._decoder_cache[key] = fn
        return fn

    def decode(self, soft_info_syndrome: np.ndarray) -> np.ndarray:
        """Decode a single soft syndrome (length m, log-likelihood values)."""
        out = self.decode_batch(np.asarray(soft_info_syndrome, dtype=np.float64)[None, :])
        return out[0]

    def decode_batch(self, soft_syndromes: np.ndarray) -> np.ndarray:
        """Decode a (B, m) batch of soft syndromes; the final soft syndromes
        are kept in ``soft_syndrome_batch``."""
        soft_syndromes = np.atleast_2d(np.asarray(soft_syndromes, dtype=np.float64))
        if soft_syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {soft_syndromes.shape[1]}."
            )
        # cast on the host: the card receives the decoder's dtype
        soft_in = torch.from_numpy(soft_syndromes).to(self._dtype)
        result, soft_out = self._soft_decode_fn()(
            soft_in, self._init_llr(), float(self.cutoff), float(self.sigma)
        )
        self.converge_batch = _to_numpy(result.converged)
        self.iter_batch = _to_numpy(result.iterations)
        self._llr_batch = result.llr_posterior
        self._converge = bool(self.converge_batch[0])
        self._iter = int(self.iter_batch[0])
        self._log_prob_ratios = _to_numpy(result.llr_posterior[0])
        self._soft_out = soft_out
        self._soft_syndrome = _to_numpy(soft_out[0])
        decodings = _to_numpy(result.decoding)
        self._decoding = decodings[0]
        return decodings

    @property
    def soft_syndrome(self) -> np.ndarray:
        """The updated soft syndrome after decoding."""
        return np.asarray(self._soft_syndrome)

    @property
    def soft_syndrome_batch(self) -> Optional[np.ndarray]:
        """The last batch's (B, m) final soft syndromes, copied to the host
        when first read."""
        if isinstance(self._soft_out, torch.Tensor):
            self._soft_out = _to_numpy(self._soft_out)
        return self._soft_out
