"""LsdDecoder: standalone localized-statistics decoding, no BP stage.

Port of ``ldpc_tpu.decoders.lsd_decoder.LsdDecoder`` (reference:
src_python/ldpc/lsd_decoder/_lsd_decoder.pyx): the user's per-bit weights
(soft information) guide the cluster growth (_lsd_decoder.pyx:129-175).
The whole batch decodes at once on ``device`` with
:func:`ldpc_tpu_torch.ops.lsd.make_lsd_decoder`: kernel K4' at order 0,
K4' and K5' at order w.
"""

import warnings
from typing import Optional, Union

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops.pcm import compile_pcm
from ldpc_tpu_torch.decoders.base import _device_llrs, _to_numpy
from ldpc_tpu_torch.decoders.lsd_common import METHOD_NAMES, parse_lsd_method
from ldpc_tpu_torch.ops import lsd as lsd_ops


class LsdDecoder:
    """Standalone batched LSD decoder (lsd.hpp:683-784).

    ``bits_per_step`` (bits a cluster admits per growth round; 0 = all of
    its boundary), ``lsd_order``, ``lsd_method`` ('LSD_0' | 'LSD_E' |
    'LSD_CS' plus the reference's aliases); plus ``device``, where the
    decoder's tensors live.
    """

    def __init__(
        self,
        pcm,
        bits_per_step: int = 1,
        lsd_order: int = 0,
        lsd_method: Union[str, int] = 0,
        device="cuda",
    ):
        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        self.bits_per_step = bits_per_step if bits_per_step != 0 else self.n
        self._device = resolve_device(device)
        self._lsd_method = 0
        self._lsd_order = 0
        self.lsd_method = lsd_method
        self.lsd_order = lsd_order
        self._graph = compile_pcm(self._pcm)
        self._fn = None
        self._decoding = np.zeros(self.n, dtype=np.uint8)
        self.valid_batch = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def lsd_method(self) -> Optional[str]:
        return METHOD_NAMES.get(self._lsd_method)

    @lsd_method.setter
    def lsd_method(self, method) -> None:
        self._lsd_method = parse_lsd_method(method)
        if self._lsd_method == lsd_ops.LSD_0:
            self._lsd_order = 0
        self._fn = None

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
        self._fn = None

    def _decode_fn(self):
        if self._fn is None:
            self._fn = lsd_ops.make_lsd_decoder(
                self._graph,
                lsd_method=max(self._lsd_method, 0),
                lsd_order=self._lsd_order,
                bits_per_step=self.bits_per_step,
                device=self._device,
            )
        return self._fn

    def decode(self, syndrome: np.ndarray, bit_weights: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        bit_weights = np.asarray(bit_weights, dtype=np.float64)
        if not len(bit_weights) == self.n:
            raise ValueError(
                f"The bit weights must have length {self.n}. Not {len(bit_weights)}."
            )
        out = self.decode_batch(
            syndrome[None, :].astype(np.uint8), bit_weights[None, :]
        )[0]
        return out.astype(syndrome.dtype)

    def decode_batch(
        self, syndromes: np.ndarray, bit_weights: np.ndarray
    ) -> np.ndarray:
        """Decode a (B, m) batch guided by ``bit_weights``: (B, n), or one
        (n,) or (1, n) vector shared by every row and broadcast on the
        device. Zero syndromes decode to zero and count as valid. Returns
        the (B, n) uint8 decodings; ``valid_batch`` holds each row's
        validity."""
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        bit_weights = np.asarray(bit_weights, dtype=np.float32)
        if bit_weights.ndim == 2 and bit_weights.shape[0] == 1:
            bit_weights = bit_weights[0]
        syn = torch.from_numpy(syndromes).to(self._device)
        weights = _device_llrs(bit_weights, syn.shape[0], self.n, self._device)
        dec, valid = self._decode_fn()(syn, weights)
        nonzero = (syn != 0).any(dim=1)
        dec = dec * nonzero[:, None].to(dec.dtype)
        self.valid_batch = _to_numpy(valid | ~nonzero)
        out = _to_numpy(dec)
        self._decoding = out[0]
        return out

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(np.uint8)
