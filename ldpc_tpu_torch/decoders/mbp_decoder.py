"""MBP decoder: quaternary (GF(4)) belief propagation for Pauli noise.

API parity with the reference
(reference: src_python/ldpc/mbp_decoder/_mbp_decoder.pyx): construct from
a GF(4) stabilizer matrix ``Hgf4`` (entries 1=X, 2=Y, 3=Z) or a CSS pair
``HX_CSS``/``HZ_CSS`` (stacked as [HZ->Pauli Z rows; HX->Pauli X rows],
_mbp_decoder.pyx:90-115); ``xyz_bias`` splits a scalar ``error_rate``
into per-Pauli channels (:48-63); ``alpha`` (3,n)/scalar, ``beta``,
``gamma`` are the MBP memory parameters.

Deviation from the reference: with ``Hgf4`` input, ``decode`` returns
the GF(4) correction vector (the reference's OUTPUT_TYPE bookkeeping
makes it unconditionally return the CSS pair — a bug upstream,
_mbp_decoder.pyx:27-37 vs :204-222).

Port of ``ldpc_tpu.decoders.mbp_decoder``, with the same constructor,
validation and properties, plus ``device``: the batch decodes there on
kernel K9' (:mod:`ldpc_tpu_torch.ops.mbp`), or on its plain version with
``device="cpu"``.
"""

import warnings
from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops import mbp as mbp_ops
from ldpc_tpu_torch.ops.bp import torch_dtype


def uf_weights(lp: np.ndarray):
    """The union-find weights ``(wx, wz)`` of ``uf_decode`` from one row's
    (3, n) MBP posteriors: the log-odds of an X-type (X or Y) and a Z-type
    (Y or Z) error on each qubit (_mbp_decoder.pyx:228-266)."""
    with np.errstate(over="ignore", divide="ignore"):
        pz = 1 / (np.exp(lp[1]) + 1) + 1 / (np.exp(lp[2]) + 1)
        px = 1 / (np.exp(lp[1]) + 1) + 1 / (np.exp(lp[0]) + 1)
        wz = np.where(pz == 0, np.inf, np.log((1 - pz) / pz))
        wx = np.where(px == 0, np.inf, np.log((1 - px) / px))
    return wx, wz


class MbpDecoder:
    """Batched MBP decoder (mbp.hpp; arXiv:2104.13659)."""

    def __init__(
        self,
        Hgf4=None,
        HX_CSS=None,
        HZ_CSS=None,
        error_rate: Optional[float] = None,
        xyz_bias: List[float] = (1, 1, 1),
        error_channel: Optional[List[List[float]]] = None,
        max_iter: int = 0,
        alpha_parameter=1.0,
        beta_parameter: float = 0.0,
        bp_method: Union[str, int] = 0,
        gamma_parameter: float = 1.0,
        dtype=torch.float64,
        device="cuda",
    ):
        self._device = resolve_device(device)
        if Hgf4 is not None:
            self.output_type = "gf4"
            H = (
                np.asarray(Hgf4.todense(), np.uint8)
                if scipy.sparse.issparse(Hgf4)
                else np.asarray(Hgf4, np.uint8)
            )
        elif HX_CSS is not None and HZ_CSS is not None:
            self.output_type = "css"
            hx = (
                np.asarray(HX_CSS.todense(), np.uint8)
                if scipy.sparse.issparse(HX_CSS)
                else np.asarray(HX_CSS, np.uint8)
            )
            hz = (
                np.asarray(HZ_CSS.todense(), np.uint8)
                if scipy.sparse.issparse(HZ_CSS)
                else np.asarray(HZ_CSS, np.uint8)
            )
            if hx.shape[1] != hz.shape[1]:
                raise ValueError(
                    "The number of columns in HX_CSS should be equal to the "
                    "number of columns in HZ_CSS."
                )
            # [HZ rows as Pauli Z; HX rows as Pauli X]
            H = np.vstack([hz * 3, hx * 1]).astype(np.uint8)
            self._hx, self._hz = hx, hz
            self._mz = hz.shape[0]
        else:
            raise ValueError(
                "Please enter either the GF4 parity check matrix, or the GF2 "
                "HX and HZ CSS parity check components."
            )
        self.stab_count, self.qubit_count = H.shape
        self.max_iter = max_iter if max_iter != 0 else self.qubit_count

        bias = np.asarray(xyz_bias, dtype=np.float64)
        if bias.sum() > 0:
            bias = bias / bias.sum()
        self.xyz_bias = bias
        if error_channel is not None:
            if error_rate is not None:
                warnings.warn(
                    "An error channel has been provided as input. This will "
                    f"override the 'error_rate={error_rate}' parameter that "
                    "has also been inputted."
                )
            chan = np.asarray(error_channel, dtype=np.float64)
            if chan.shape != (3, self.qubit_count):
                raise ValueError(
                    f"error_channel must have shape (3, {self.qubit_count})."
                )
        elif error_rate is not None:
            chan = np.tile(
                (bias * error_rate)[:, None], (1, self.qubit_count)
            )
        else:
            raise ValueError("Please specify an error_rate or error_channel.")
        self._channel = chan

        self._alpha = self._parse_alpha(alpha_parameter)

        sval = str(bp_method).lower()
        if sval in ("prod_sum", "product_sum", "ps", "0", "prod sum"):
            self.bp_method = mbp_ops.PRODUCT_SUM
        elif sval in ("min_sum", "minimum_sum", "ms", "1", "minimum sum", "min sum"):
            self.bp_method = mbp_ops.MINIMUM_SUM
        else:
            raise ValueError(
                f"BP method '{bp_method}' is invalid. Please choose from the "
                "following methods: 'product_sum', 'minimum_sum'"
            )
        self.beta_parameter = float(beta_parameter)
        self.gamma_parameter = float(gamma_parameter)
        self._dtype = torch_dtype(dtype)
        self._g4 = mbp_ops.compile_gf4(H)
        self._dense_gf4 = H
        self._fn = self._make_fn()
        self._uf_cache = {}
        self.converge = False
        self.iterations = 0
        self._decoding = np.zeros(self.qubit_count, np.uint8)
        self._llrs = np.zeros((3, self.qubit_count))

    # ------------------------------------------------------------------
    def _parse_alpha(self, alpha) -> np.ndarray:
        """Scalar, (3,) per-Pauli, or (3, n) per-Pauli-per-qubit alpha
        (reference: _mbp_decoder.pyx:144-175)."""
        if isinstance(alpha, (float, int)):
            return np.full((3, self.qubit_count), float(alpha))
        alpha = np.asarray(alpha, dtype=np.float64)
        if alpha.size == 3:
            return np.tile(alpha.reshape(3, 1), (1, self.qubit_count))
        if alpha.size == 3 * self.qubit_count:
            return alpha.reshape(3, self.qubit_count)
        raise ValueError(
            "The 'alpha' input must be either a single double "
            "variable or a 3xN np.ndarray of doubles, where N is the "
            f"qubit count. The current input has dimensions {alpha.shape}."
        )

    def update_alpha(self, alpha) -> None:
        """Replace the MBP memory-strength parameter and rebuild the
        decode program (reference: _mbp_decoder.pyx:144-175; a no-op when
        ``alpha`` is None, as upstream)."""
        if alpha is None:
            return
        self._alpha = self._parse_alpha(alpha)
        self._fn = self._make_fn()

    def _make_fn(self):
        return mbp_ops.make_mbp_decoder(
            self._g4,
            self._channel,
            self.max_iter,
            self._alpha,
            self.beta_parameter,
            self.bp_method,
            self.gamma_parameter,
            device=self._device,
            dtype=self._dtype,
        )

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def alpha(self) -> np.ndarray:
        return self._alpha.copy()

    @property
    def error_channel(self) -> np.ndarray:
        return self._channel.copy()

    @property
    def log_prob_ratios(self) -> np.ndarray:
        return np.asarray(self._llrs)

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)

    @property
    def iter(self) -> int:
        return self.iterations

    # ------------------------------------------------------------------
    def _assemble_syndrome(self, syndrome, sx, sz) -> np.ndarray:
        if syndrome is not None:
            syndrome = np.asarray(syndrome)
            if not len(syndrome) == self.stab_count:
                raise ValueError(
                    f"The syndrome must have length {self.stab_count}. "
                    f"Not {len(syndrome)}."
                )
            return syndrome.astype(np.uint8)
        if sx is not None and sz is not None:
            return np.concatenate(
                [np.asarray(sx), np.asarray(sz)]
            ).astype(np.uint8)
        raise ValueError("Invalid syndrome input.")

    def decode(self, syndrome=None, sx=None, sz=None):
        synd = self._assemble_syndrome(syndrome, sx, sz)
        dec = self.decode_batch(synd[None, :])[0]
        if self.output_type == "gf4":
            return dec
        outx = ((dec == 1) | (dec == 2)).astype(np.uint8)
        outz = ((dec == 2) | (dec == 3)).astype(np.uint8)
        return outx, outz

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """Decode a (B, stab_count) batch; returns GF(4) corrections."""
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        dec, llrs, conv, iters = self._fn(torch.from_numpy(syndromes))
        self.converge_batch = conv.cpu().numpy()
        self.iter_batch = iters.cpu().numpy()
        self.converge = bool(self.converge_batch[0])
        self.iterations = int(self.iter_batch[0])
        self._llrs = llrs[0].cpu().numpy()
        dec = dec.cpu().numpy()
        self._decoding = dec[0]
        return dec

    def uf_decode(self, sx=None, sz=None):
        """MBP + union-find fallback for CSS codes
        (_mbp_decoder.pyx:228-266): UF weights derive from the MBP
        per-Pauli posteriors."""
        if self.output_type != "css":
            raise ValueError("uf_decode requires CSS (HX_CSS/HZ_CSS) input.")
        out = self.decode(sx=sx, sz=sz)
        if self.converge:
            return out
        wx, wz = uf_weights(self._llrs)
        outx = self._uf("x").decode(np.asarray(sx, np.uint8), llrs=wx, bits_per_step=1)
        outz = self._uf("z").decode(np.asarray(sz, np.uint8), llrs=wz, bits_per_step=1)
        return outx, outz

    def _uf(self, which: str):
        fn = self._uf_cache.get(which)
        if fn is None:
            from ldpc_tpu_torch.decoders.union_find import UnionFindDecoder

            pcm = self._hz if which == "x" else self._hx
            fn = UnionFindDecoder(
                scipy.sparse.csr_matrix(pcm), uf_method=True, device=self._device
            )
            self._uf_cache[which] = fn
        return fn


# reference-compatible lowercase alias (src_python/ldpc/__init__.py)
mbp_decoder = MbpDecoder
