"""Legacy rep-code circuit simulator (port of
``ldpc_tpu.ckt_noise.not_an_arb_ckt_simulator``; reference:
src_python/ldpc/ckt_noise/not_an_arb_ckt_simulator.py).

Kept for API parity: the reference deprecates everything here in favour
of :func:`bipartite_edge_coloring` and
:func:`make_css_code_memory_circuit`; this port carries the same
deprecation warnings. ``count_logical_errors`` decodes the sampled
shots through the port's batched BP+OSD decoder (one device batch)
instead of the reference's per-shot pymatching loop
(not_an_arb_ckt_simulator.py:231-251).
"""

import warnings
from typing import List, Union

import numpy as np
from scipy.sparse import csr_matrix

from ldpc_tpu_torch.ckt_noise.bipartite_edge_coloring import bipartite_edge_coloring


def rep_code(d: int):
    """Repetition-code check matrix + logical
    (reference: not_an_arb_ckt_simulator.py:11-25)."""
    h = np.zeros((d - 1, d), dtype=np.int8)
    for i in range(d - 1):
        h[i, i] = 1
        h[i, i + 1] = 1
    return csr_matrix(h), csr_matrix([[1] + [0] * (d - 1)])


def get_stabilizer_time_steps(pcm: csr_matrix):
    """CNOT scheduling time steps from the edge coloring
    (reference: not_an_arb_ckt_simulator.py:28-81; deprecated there —
    use :func:`bipartite_edge_coloring` directly)."""
    warnings.warn(
        "get_stabilizer_time_steps(pcm) is deprecated and will be removed "
        "in a future version. Use bipartite_edge_coloring instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    col_mat = csr_matrix(bipartite_edge_coloring(csr_matrix(pcm)))
    max_time_steps = int(np.max(col_mat.data))
    num_stabs = col_mat.shape[0]
    time_steps: List[List[Union[int, None]]] = [
        [None] * num_stabs for _ in range(max_time_steps)
    ]
    measured_bits: List[List[Union[int, None]]] = [
        [None] * max_time_steps for _ in range(num_stabs)
    ]
    for k in range(col_mat.shape[0]):
        for ptr in range(col_mat.indptr[k], col_mat.indptr[k + 1]):
            t = int(col_mat.data[ptr]) - 1
            q = int(col_mat.indices[ptr])
            time_steps[t][k] = q
            measured_bits[k][t] = q
    return time_steps, measured_bits


def stim_circuit_from_time_steps(
    pcm: csr_matrix,
    logicals: csr_matrix,
    time_steps: List[List[Union[int, None]]],
    measured_bits: List[List[Union[int, None]]],
    after_clifford_depolarization: float = 0.0,
    after_reset_flip_probability: float = 0.0,
    before_measure_flip_probability: float = 0.0,
    before_round_data_depolarization: float = 0.0,
    rounds: int = 3,
):
    """Memory-experiment stim circuit for an X-check-only (classical)
    code (reference: not_an_arb_ckt_simulator.py:83-228; deprecated
    there — use :func:`make_css_code_memory_circuit` for CSS codes).

    Qubits 0..n-1 are data, n..n+m-1 are check ancillas. The circuit is
    init block (reset, first syndrome round, per-check detectors), a
    repeated block (`rounds` copies of syndrome extraction with
    difference detectors), and a final block (data measurement, space
    detectors, observable includes).
    """
    warnings.warn(
        "stim_circuit_from_time_steps(pcm) is deprecated and will be "
        "removed in a future version. Use make_css_code_memory_circuit "
        "instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    import stim  # optional dependency

    pcm = csr_matrix(pcm)
    logicals = csr_matrix(logicals)
    m, n = pcm.shape
    data = np.arange(n)
    checks = np.arange(n, n + m)

    def append_syndrome_round(circ):
        if before_round_data_depolarization > 0:
            circ.append(
                "DEPOLARIZE1", data, before_round_data_depolarization
            )
            circ.append("TICK", [])
        for tick in time_steps:
            for check, bit in enumerate(tick):
                if bit is None:
                    continue
                circ.append("CX", [bit, n + check])
                if after_clifford_depolarization > 0:
                    circ.append(
                        "DEPOLARIZE2",
                        [bit, n + check],
                        after_clifford_depolarization,
                    )
            circ.append("TICK", [])
        circ.append("MR", checks, before_measure_flip_probability)
        circ.append("X_ERROR", checks, after_reset_flip_probability)

    init_circuit = stim.Circuit()
    init_circuit.append("R", np.arange(n + m))
    init_circuit.append("TICK")
    append_syndrome_round(init_circuit)
    for idx in range(m):
        init_circuit.append(
            "DETECTOR", [stim.target_rec(-m + idx)], (idx + n, 0)
        )

    circuit = stim.Circuit()
    circuit.append("TICK", [])
    append_syndrome_round(circuit)
    circuit.append("SHIFT_COORDS", [], [0, 1])
    for idx in range(m):
        circuit.append(
            "DETECTOR",
            [stim.target_rec(-2 * m + idx), stim.target_rec(-m + idx)],
            (idx + n, 0),
        )
    circuit *= rounds

    final_circuit = stim.Circuit()
    if before_round_data_depolarization > 0:
        final_circuit.append(
            "DEPOLARIZE1", data, before_round_data_depolarization
        )
    final_circuit.append("M", data)
    for k in range(m):
        record_targets = [stim.target_rec(-m - n + k)]
        for bit in pcm[k].indices:
            record_targets.append(stim.target_rec(-n + int(bit)))
        final_circuit.append("DETECTOR", record_targets, (k, 1))
    for idx in range(logicals.shape[0]):
        final_circuit.append(
            "OBSERVABLE_INCLUDE",
            [
                stim.target_rec(-n + int(k))
                for k in logicals[idx].indices
            ],
            idx,
        )

    return init_circuit + circuit + final_circuit


def count_logical_errors(circuit, num_shots: int, device="cuda") -> int:
    """Sample a stim circuit and count shots whose predicted observables
    disagree with the sampled ones (reference behavior:
    not_an_arb_ckt_simulator.py:231-251). Decoding runs as ONE batched
    BP+OSD call on the DEM check matrices, on ``device``, instead of a
    per-shot pymatching loop."""
    from ldpc_tpu_torch.ckt_noise.dem_matrices import (
        detector_error_model_to_check_matrices,
    )
    from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder
    from ldpc_tpu_torch.device import resolve_device

    device = resolve_device(device)

    sampler = circuit.compile_detector_sampler()
    detection_events, observable_flips = sampler.sample(
        num_shots, separate_observables=True
    )
    dem = circuit.detector_error_model(decompose_errors=True)
    mats = detector_error_model_to_check_matrices(dem)
    decoder = BpOsdDecoder(
        mats.check_matrix,
        error_channel=list(mats.priors),
        max_iter=30,
        bp_method="minimum_sum",
        ms_scaling_factor=0.625,
        osd_method="osd_0",
        osd_order=0,
        device=device,
    )
    corr = decoder.decode_batch(detection_events.astype(np.uint8))
    predictions = (corr @ mats.observables_matrix.T.toarray()) % 2
    return int(
        (predictions != observable_flips.astype(np.uint8))
        .any(axis=1)
        .sum()
    )
