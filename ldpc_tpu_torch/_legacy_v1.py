"""ldpc v1 compatibility shims (port of ``ldpc_tpu._legacy_v1``).

API parity with the reference's legacy layer
(reference: src_python/ldpc/_legacy_ldpc_v1/_legacy_bp_decoder.py,
_legacy_bposd_decoder.py): lowercase ``bp_decoder`` / ``bposd_decoder``
classes with the v1 constructor signature (``channel_probs`` list,
``"ps"`` default method), emitting the same deprecation warnings. Like
every decoder of the port they take ``device=`` and run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

import warnings

import numpy as np

from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder
from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder


def _v1_channel(parity_check_matrix, channel_probs, error_rate):
    n = parity_check_matrix.shape[1]
    if channel_probs[0] is not None:
        if len(channel_probs) != n:
            raise ValueError(
                "The length of the channel probability vector must be eqaul "
                f"to the block length n={n}."
            )
        return np.asarray(channel_probs, dtype=float)
    if error_rate is None or error_rate == 0:
        raise ValueError(
            "Either the error_rate or channel_probs must be specified."
        )
    return None


class bp_decoder(BpDecoder):
    """Legacy ldpc_v1 belief-propagation decoder
    (reference: _legacy_bp_decoder.py:6-117)."""

    def __init__(
        self,
        parity_check_matrix,
        error_rate=None,
        max_iter=0,
        bp_method="ps",
        ms_scaling_factor=1.0,
        channel_probs=[None],
        input_vector_type="auto",
        error_channel=None,
        device="cuda",
    ):
        warnings.warn(
            "This is the old syntax for the `bp_decoder` from `ldpc v1`. "
            "Use the `BpDecoder` class from `ldpc v2` for additional features."
        )
        error_channel = _v1_channel(
            parity_check_matrix, channel_probs, error_rate
        )
        if isinstance(input_vector_type, int) and input_vector_type == -1:
            input_vector_type = "auto"
        if input_vector_type not in ("auto", "syndrome", "received_vector"):
            raise Exception(
                "TypeError: input_vector type must be either 'syndrome', "
                f"'received_vector' or 'auto'. Not {input_vector_type}"
            )
        super().__init__(
            parity_check_matrix,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=int(max_iter),
            bp_method=bp_method,
            ms_scaling_factor=float(ms_scaling_factor),
            input_vector_type=input_vector_type,
            device=device,
        )

    @property
    def channel_probs(self):
        return self.error_channel

    def update_channel_probs(self, channel):
        self.error_channel = channel


class bposd_decoder(BpOsdDecoder):
    """Legacy ldpc_v1 BP+OSD decoder
    (reference: _legacy_bposd_decoder.py:6-125)."""

    def __init__(
        self,
        parity_check_matrix,
        error_rate=None,
        max_iter=0,
        bp_method="ps",
        ms_scaling_factor=1.0,
        channel_probs=[None],
        osd_method="osd_0",
        osd_order=0,
        device="cuda",
    ):
        warnings.warn(
            "This is the old syntax for the `bposd_decoder` from `ldpc v1`. "
            "Use the `BpOsdDecoder` class from `ldpc v2` for additional "
            "features."
        )
        error_channel = _v1_channel(
            parity_check_matrix, channel_probs, error_rate
        )
        super().__init__(
            parity_check_matrix,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=int(max_iter),
            bp_method=bp_method,
            ms_scaling_factor=float(ms_scaling_factor),
            osd_method=osd_method,
            osd_order=osd_order,
            device=device,
        )

    @property
    def channel_probs(self):
        return self.error_channel

    def update_channel_probs(self, channel):
        self.error_channel = channel
