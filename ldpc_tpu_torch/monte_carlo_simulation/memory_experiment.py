"""Multi-round (circuit-memory) decoding with sliding windows, a copy of
``ldpc_tpu.monte_carlo_simulation.memory_experiment``
(reference: src_python/ldpc/monte_carlo_simulation/memory_experiment_v2.py,
after Timo/Lucas' analog-information decoding work).

This is the time-axis "sequence scaling" machinery: ``repetitions``
noisy measurement rounds are decoded jointly on a space-time PCM; the
window slides by committing the first half and propagating its
correction's syndrome into the tentative half.
"""

from typing import Optional, Tuple

import numpy as np
from scipy.sparse import block_diag, csr_matrix, eye, hstack

from ldpc_tpu_torch.monte_carlo_simulation.simulation_utils import (
    get_virtual_check_init_vals,
)


def build_multiround_pcm(pcm, repetitions: int, format: str = "csr"):
    """Space-time PCM H3D = (H_diag | id staircase)
    (reference: memory_experiment_v2.py:12-41).

    ``H_diag`` repeats H on the block diagonal once per round;
    the identity staircase couples each round's checks to its own and
    the previous round's measurement-error variables.
    """
    if not isinstance(pcm, csr_matrix):
        pcm = csr_matrix(pcm)
    m = pcm.shape[0]
    H_diag = block_diag([pcm] * (repetitions + 1), format=format)
    id_diag = block_diag(
        [eye(m, format=format)] * (repetitions + 1), format=format
    )
    id_offdiag = eye(m * (repetitions + 1), k=-m, format=format)
    return hstack([H_diag, id_diag + id_offdiag], format=format)


def move_syndrome(syndrome, data_type=np.int32):
    """Slide the window one region up (reference:
    memory_experiment_v2.py:44-53)."""
    T = syndrome.shape[1] // 2
    new_syndrome = np.zeros(syndrome.shape, dtype=data_type)
    new_syndrome[:, :T] = syndrome[:, T:]
    return new_syndrome


def get_updated_decoder(
    decoding_method: str, decoder, new_channel, H3D=None
):
    """Refresh the decoder's channel for the next window
    (reference: memory_experiment_v2.py:56-69). The 'matching'
    (pymatching) branch is kept behind a lazy import."""
    if decoding_method in ("bposd", "lsd"):
        decoder.update_channel_probs(new_channel)
        return decoder
    if decoding_method == "matching":
        from pymatching import Matching  # optional dependency

        weights = np.clip(
            np.log((1 - new_channel) / new_channel),
            a_min=-16777215,
            a_max=16777215,
        )
        return Matching(H3D, weights=weights)
    raise ValueError("Unknown decoding method", decoding_method)


def decode_multiround(
    syndrome: np.ndarray,
    H: np.ndarray,
    decoder,
    channel_probs: np.ndarray,
    repetitions: int,
    last_round: bool = False,
    analog_syndr: Optional[np.ndarray] = None,
    check_block_size: int = 0,
    sigma: float = 0.0,
    H3D: Optional[np.ndarray] = None,
    decoding_method: str = "lsd",
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
    """One overlapping-window decode step
    (reference: memory_experiment_v2.py:72-160).

    Computes difference syndromes across the window's rounds, decodes
    the space-time system, commits the first ``repetitions//2`` rounds'
    correction, and propagates its syndrome through the tentative
    region. With analog syndrome information, the time-like variable
    channel is re-initialized from the analog LLRs.
    """
    analog_tg = analog_syndr is not None
    diff_syndrome = syndrome.copy()
    diff_syndrome[:, 1:] = (syndrome[:, 1:] - syndrome[:, :-1]) % 2
    bp_iter = 0
    region_size = repetitions // 2

    if analog_tg:
        analog_init_vals = get_virtual_check_init_vals(
            analog_syndr.flatten("F"), sigma
        )
        new_channel = np.hstack(
            (channel_probs[:check_block_size], analog_init_vals)
        )
        if last_round:
            new_channel[-H.shape[0]:] = 1e-15
        decoder = get_updated_decoder(
            decoding_method, decoder, new_channel, H3D
        )
    elif last_round:
        new_channel = np.copy(channel_probs)
        new_channel[-H.shape[0]:] = 1e-15
        decoder = get_updated_decoder(
            decoding_method, decoder, new_channel, H3D
        )

    decoded = decoder.decode(diff_syndrome.flatten("F"))
    if decoding_method == "bposd":
        bp_iter = decoder.iter

    n = H.shape[1]
    space_correction = (
        decoded[: n * repetitions].reshape((repetitions, n)).T
    )
    if not last_round:
        time_correction = (
            decoded[n * repetitions:]
            .reshape((repetitions, H.shape[0]))
            .T
        )
        time_correction = np.hstack(
            (time_correction, np.zeros((H.shape[0], 1), dtype=np.int32))
        )
        # commit region correction
        decoded = (np.cumsum(space_correction, 1) % 2)[:, region_size - 1]
        corr_syndrome = (H @ decoded) % 2
        # propagate through the tentative region
        syndrome[:, region_size:] = (
            (syndrome[:, region_size:] + corr_syndrome[:, None]) % 2
        ).astype(np.int32)
        syndrome[:, region_size] = (
            (syndrome[:, region_size] + time_correction[:, region_size - 1])
            % 2
        ).astype(np.int32)
    else:
        decoded = (np.cumsum(space_correction, 1) % 2)[:, -1]

    return decoded.astype(np.int32), syndrome, analog_syndr, bp_iter
