"""UnionFindDecoder: standalone union-find decoding, no BP stage.

Port of ``ldpc_tpu.decoders.union_find.UnionFindDecoder`` (reference:
src_python/ldpc/union_find_decoder/_union_find_decoder.pyx): ``uf_method``
truthy selects the matrix (inversion) mode, falsy the peeling mode
(_union_find_decoder.pyx:64,145-157); ``decode(syndrome, llrs=None,
bits_per_step=0)`` may guide the growth with soft information. The whole
batch decodes at once on ``device`` (:func:`ldpc_tpu_torch.ops.uf.
make_uf_decoder` / ``make_peel_decoder``, kernel K4').
"""

from typing import Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops.pcm import compile_pcm
from ldpc_tpu_torch.decoders.base import _device_llrs, _to_numpy
from ldpc_tpu_torch.ops import uf as uf_ops


class UnionFindDecoder:
    """Union-find decoder (union_find.hpp; arXiv:1709.06218).

    ``uf_method=True`` is the matrix (inversion) mode and works on any PCM;
    ``uf_method=False`` (default) is the peeling mode, which requires column
    degree <= 2 (point-like syndromes). ``device`` is where the decoder's
    tensors live: ``"cuda"`` by default, ``"cpu"`` runs the kernels' plain
    versions.
    """

    def __init__(self, pcm, uf_method: Union[bool, str] = False, device="cuda"):
        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        col_deg = np.asarray((self._pcm != 0).sum(axis=0)).ravel()
        if (col_deg == 0).any():
            raise ValueError(
                "Invalid parity check matrix. Column weight is zero."
            )
        self.uf_method = bool(uf_method)
        if not self.uf_method and col_deg.max() > 2:
            raise ValueError(
                "Peel decoder only works for planar codes. Use the "
                "matrix_decode method for more general codes."
            )
        self._device = resolve_device(device)
        self._graph = compile_pcm(self._pcm)
        self._cache = {}
        self._decoding = np.zeros(self.n, dtype=np.uint8)
        self.valid_batch = None

    @property
    def device(self) -> torch.device:
        return self._device

    def _fn(self, bits_per_step: int):
        fn = self._cache.get(bits_per_step)
        if fn is None:
            maker = uf_ops.make_uf_decoder if self.uf_method else uf_ops.make_peel_decoder
            fn = maker(self._graph, bits_per_step=bits_per_step, device=self._device)
            self._cache[bits_per_step] = fn
        return fn

    def decode(
        self,
        syndrome: np.ndarray,
        llrs: Optional[np.ndarray] = None,
        bits_per_step: int = 0,
    ) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        if llrs is not None and not len(llrs) == self.n:
            raise ValueError(
                f"The llrs must have length {self.n}. Not {len(llrs)}."
            )
        out = self.decode_batch(
            syndrome[None, :].astype(np.uint8),
            None if llrs is None else np.asarray(llrs)[None, :],
            bits_per_step,
        )[0]
        return out.astype(syndrome.dtype)

    def decode_batch(
        self,
        syndromes: np.ndarray,
        llrs: Optional[np.ndarray] = None,
        bits_per_step: int = 0,
    ) -> np.ndarray:
        """Decode a (B, m) batch. ``llrs`` guide the growth: (B, n), or (n,)
        shared by every row; without them every boundary bit joins each
        round. Zero syndromes decode to zero and count as valid. Returns the
        (B, n) uint8 decodings; ``valid_batch`` holds each row's validity."""
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        syn = torch.from_numpy(syndromes).to(self._device)
        guided = llrs is not None
        llr_t = _device_llrs(llrs, syn.shape[0], self.n, self._device)
        dec, valid = self._fn(bits_per_step if guided else 0)(syn, llr_t)
        nonzero = (syn != 0).any(dim=1)
        dec = dec * nonzero[:, None].to(dec.dtype)
        self.valid_batch = _to_numpy(valid | ~nonzero)
        out = _to_numpy(dec)
        self._decoding = out[0]
        return out

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(np.uint8)
