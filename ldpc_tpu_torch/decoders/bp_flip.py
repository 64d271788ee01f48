"""FlipDecoder and BpFlipDecoder (port of ``ldpc_tpu.decoders.bp_flip``).

Reference: src_python/ldpc/bp_flip/_bp_flip.pyx and src_cpp/flip.hpp.
``FlipDecoder`` is the standalone greedy flip / p-flip decoder on the flip
sweep kernel (:mod:`ldpc_tpu_torch.ops.flip`). ``BpFlipDecoder.decode``
runs flip *first*, then BP (kernel K1') on the residual syndrome, and XORs
the two corrections (_bp_flip.pyx:44-61; the order is the reverse of the
class name). BP failures keep their decodings, so ``H x = s`` holds on the
converged rows only.
"""

import time
from typing import List, Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.decoders.base import BpDecoderBase, _to_numpy
from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops import flip as flip_ops
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch


class FlipDecoder:
    """Standalone batched flip / p-flip decoder (flip.hpp:61-137).

    ``max_iter`` sweeps at most (0 = block length); every ``pfreq``-th sweep
    breaks ties at random (0 = never); ``seed`` keys the coin (0 = from the
    clock, as the reference does); ``device`` is where the decoder's tensors
    live. Unlike the reference's C++-only class, a zero syndrome converges
    at once (the reference reaches flip only through BpFlipDecoder, which
    short-circuits zero syndromes first).
    """

    def __init__(
        self, pcm, max_iter: int = 0, pfreq: int = 0, seed: int = 0, device="cuda"
    ):
        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or scipy.sparse.spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        self.max_iter = max_iter if max_iter != 0 else self.n
        self.pfreq = pfreq
        self.seed = seed
        self._device = resolve_device(device)
        self._graph = compile_pcm(self._pcm)
        self._fn = flip_ops.make_flip_decoder(
            self._graph, self.max_iter, self.pfreq, self._device
        )
        self.converge = False
        self.iterations = 0
        self.converge_batch = None
        self.iter_batch = None
        self._decoding = np.zeros(self.n, dtype=np.uint8)

    @property
    def device(self) -> torch.device:
        return self._device

    def _seed(self) -> int:
        return self.seed if self.seed != 0 else time.time_ns() & 0x7FFFFFFF

    def _decode_device(self, syn: torch.Tensor) -> torch.Tensor:
        """Flip (B, m) device syndromes; keeps the batch properties and
        returns the (B, n) uint8 decodings on the device."""
        dec, conv, iters = self._fn(syn, self._seed())
        self.converge_batch = _to_numpy(conv)
        self.iter_batch = _to_numpy(iters)
        self.converge = bool(self.converge_batch[0])
        self.iterations = int(self.iter_batch[0])
        return dec

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """Decode a (B, m) batch; ``converge_batch`` and ``iter_batch`` hold
        each row's convergence and sweep count."""
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        dec = _to_numpy(self._decode_device(torch.from_numpy(syndromes).to(self._device)))
        self._decoding = dec[0]
        return dec

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)


class BpFlipDecoder(BpDecoderBase):
    """Flip pre-decoding followed by BP on the residual syndrome
    (reference: _bp_flip.pyx:10-61).

    Parameters mirror ``ldpc_tpu.BpFlipDecoder``: the BP parameters of
    :class:`~ldpc_tpu_torch.BpDecoder`, ``flip_iterations`` (flip sweeps, 0
    = block length), ``pflip_frequency``, ``pflip_seed``; plus ``device``.
    ``osd_method`` and ``osd_order`` are accepted and unused, as there.
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
        flip_iterations: int = 0,
        pflip_frequency: int = 0,
        pflip_seed: int = 0,
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
        self.flip_iterations = flip_iterations
        self._flip = FlipDecoder(
            self._pcm,
            max_iter=flip_iterations,
            pfreq=pflip_frequency,
            seed=pflip_seed,
            device=self._device,
        )
        self._tg = graph_to_torch(self.graph, self._device)

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """Decode a (B, m) batch: flip, the residual syndrome s ^ H x_flip
        (an XOR over each check's bits), BP on it, and the XOR of the two
        decodings. ``converge_batch`` and ``iter_batch`` are BP's on the
        residual; zero syndromes decode to zero and count as converged."""
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). "
                f"Not {syndromes.shape}."
            )
        syn = torch.from_numpy(syndromes).to(self._device)
        nonzero = (syn != 0).any(dim=1)
        flip_dec = self._flip._decode_device(syn)
        residual = syn ^ flip_ops.syndrome_of(self._tg, flip_dec)
        bp, _ = self._run_bp_two_phase(residual, torch.zeros_like(nonzero))
        out = (bp.decoding ^ flip_dec) * nonzero[:, None].to(torch.uint8)
        self._store_batch(bp.converged | ~nonzero, bp.iterations, bp.llr_posterior, bp.decoding)
        out = _to_numpy(out)
        self._decoding = out[0]
        return out
