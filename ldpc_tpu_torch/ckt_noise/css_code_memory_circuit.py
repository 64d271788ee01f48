"""CSS-code memory-experiment circuit generation, a copy of
``ldpc_tpu.ckt_noise.css_code_memory_circuit`` (reference: src_python/ldpc/ckt_noise/css_code_memory_circuit.py).

Builds a stim syndrome-extraction circuit for an arbitrary CSS code
following Algorithm 1 of arXiv:2109.14609: per round, X stabilizers are
measured with deg_X layers of CNOTs (ancilla-controlled), then Z
stabilizers with deg_Z layers (data-controlled); CNOT layers come from a
minimum edge coloring of each Tanner graph
(ckt_noise.bipartite_edge_coloring). stim is imported lazily.
"""

from typing import Callable, Iterable, Optional

import numpy as np
from scipy.sparse import coo_matrix, csc_matrix, csr_matrix

from ldpc_tpu_torch.ckt_noise.bipartite_edge_coloring import bipartite_edge_coloring


def _is_valid_time_steps_matrix(check_matrix, time_steps) -> bool:
    """Same sparsity pattern, positive steps, no qubit reused within a
    step (reference: css_code_memory_circuit.py:63-100)."""
    m = csr_matrix(check_matrix)
    m.eliminate_zeros()
    m.sort_indices()
    m_csr = csr_matrix(time_steps)
    m_csr.eliminate_zeros()
    m_csr.sort_indices()
    if m.shape != m_csr.shape:
        return False
    if not (
        np.array_equal(m.indices, m_csr.indices)
        and np.array_equal(m.indptr, m_csr.indptr)
    ):
        return False
    if np.any(m_csr.data < 0):
        return False
    m_csc = csc_matrix(m_csr)
    for m_sparse in (m_csr, m_csc):
        for i in range(m_sparse.indptr.shape[0] - 1):
            steps = m_sparse.data[m_sparse.indptr[i] : m_sparse.indptr[i + 1]]
            if np.unique(steps).shape[0] < steps.shape[0]:
                return False
    return True


def _append_cycle_cx_gates_from_steps(
    *,
    circuit,
    cx_steps,
    control_qubits,
    target_qubits,
    all_active_qubits,
    inactive_measure_qubits,
    after_cx_depolarization: float,
    idle_active_qubits_during_cx_depolarization: float,
    idle_inactive_qubits_during_cx_depolarization: float,
):
    """Emit the CNOT layers of one syndrome-extraction sub-round
    (reference: css_code_memory_circuit.py:13-60)."""
    cx_steps = coo_matrix(cx_steps)
    num_steps = int(np.max(cx_steps.data)) if cx_steps.nnz else 0
    for t in range(1, num_steps + 1):
        c_indices = cx_steps.row[cx_steps.data == t]
        x_indices = cx_steps.col[cx_steps.data == t]
        c_qubits = control_qubits[c_indices]
        x_qubits = target_qubits[x_indices]
        cx_targets = np.empty((c_qubits.size * 2,), dtype=c_qubits.dtype)
        cx_targets[0::2] = c_qubits
        cx_targets[1::2] = x_qubits
        circuit.append(name="CX", targets=cx_targets)
        if after_cx_depolarization > 0:
            circuit.append(
                name="DEPOLARIZE2",
                targets=cx_targets,
                arg=after_cx_depolarization,
            )
        if idle_active_qubits_during_cx_depolarization > 0:
            idle_qubits = np.setdiff1d(all_active_qubits, cx_targets)
            circuit.append(
                name="DEPOLARIZE1",
                targets=idle_qubits,
                arg=idle_active_qubits_during_cx_depolarization,
            )
        if idle_inactive_qubits_during_cx_depolarization > 0:
            circuit.append(
                name="DEPOLARIZE1",
                targets=inactive_measure_qubits,
                arg=idle_inactive_qubits_during_cx_depolarization,
            )
        circuit.append("TICK")


def make_css_code_memory_circuit(
    *,
    x_stabilizers,
    z_stabilizers,
    x_logicals,
    z_logicals,
    num_rounds: int,
    basis: str,
    after_clifford_depolarization: float = 0,
    before_round_data_depolarization: float = 0,
    before_measure_flip_probability: float = 0,
    after_reset_flip_probability: float = 0,
    idle_during_clifford_depolarization: float = 0,
    idle_inactive_measure_qubits_during_clifford_depolarization: float = 0,
    include_opposite_basis_detectors: bool = True,
    qubit_coord_func: Optional[Callable[[int], Iterable[float]]] = None,
    detector_coord_func: Optional[Callable[[int], Iterable[float]]] = None,
    shift_coords_per_round: Optional[Iterable[int]] = None,
    x_time_steps=None,
    z_time_steps=None,
):
    """Generate the memory-experiment stim circuit
    (reference: css_code_memory_circuit.py:101-454). See the reference
    docstring for full parameter semantics; behavior is matched.
    """
    import stim  # optional dependency

    x_stabilizers = csr_matrix(x_stabilizers)
    z_stabilizers = csr_matrix(z_stabilizers)
    x_logicals = csr_matrix(x_logicals)
    z_logicals = csr_matrix(z_logicals)

    basis = str(basis).upper()
    if basis not in ("X", "Z"):
        raise ValueError(f"basis must be X or Z, not {basis}")

    n = x_stabilizers.shape[1]
    rx = x_stabilizers.shape[0]
    rz = z_stabilizers.shape[0]
    if (
        z_stabilizers.shape[1] != n
        or x_logicals.shape[1] != n
        or z_logicals.shape[1] != n
    ):
        raise ValueError(
            "x_checks, z_checks, x_logicals and z_logicals must all have "
            "the same number of columns"
        )
    if shift_coords_per_round is None:
        shift_coords_per_round = [0, 1]

    data_qubits = np.arange(n, dtype=np.int64)
    x_measure_qubits = np.arange(n, n + rx, dtype=np.int64)
    z_measure_qubits = np.arange(n + rx, n + rx + rz, dtype=np.int64)
    basis_measure_qubit_offset = n if basis == "X" else n + rx

    if x_time_steps is None:
        x_time_steps = bipartite_edge_coloring(x_stabilizers)
    elif not _is_valid_time_steps_matrix(x_stabilizers, x_time_steps):
        raise ValueError(
            "x_time_steps is not a valid assignment of time steps to "
            "x_stabilizers. x_time_steps should be a valid edge coloring "
            "of the Tanner graph defining the X stabilizers (although it "
            "does not need to be a minimum edge coloring)."
        )
    else:
        x_time_steps = csr_matrix(x_time_steps, dtype=np.int64)
    if z_time_steps is None:
        z_time_steps = bipartite_edge_coloring(z_stabilizers).T
    elif not _is_valid_time_steps_matrix(z_stabilizers, z_time_steps):
        raise ValueError(
            "z_time_steps is not a valid assignment of time steps to "
            "z_stabilizers. z_time_steps should be a valid edge coloring "
            "of the Tanner graph defining the Z stabilizers (although it "
            "does not need to be a minimum edge coloring)."
        )
    else:
        z_time_steps = csr_matrix(
            csr_matrix(z_time_steps).T, dtype=np.int64
        )

    x_measure_and_data = np.concatenate([data_qubits, x_measure_qubits])
    z_measure_and_data = np.concatenate([data_qubits, z_measure_qubits])

    def append_cycle_gates_both_bases(circuit):
        if before_round_data_depolarization > 0:
            circuit.append(
                "DEPOLARIZE1",
                targets=data_qubits,
                arg=before_round_data_depolarization,
            )
        circuit.append("RX", targets=list(x_measure_qubits))
        if after_reset_flip_probability > 0:
            circuit.append(
                "Z_ERROR",
                targets=list(x_measure_qubits),
                arg=after_reset_flip_probability,
            )
        circuit.append("RZ", targets=list(z_measure_qubits))
        if after_reset_flip_probability > 0:
            circuit.append(
                "X_ERROR",
                targets=list(z_measure_qubits),
                arg=after_reset_flip_probability,
            )
        circuit.append("TICK")
        _append_cycle_cx_gates_from_steps(  # X stabilizers
            circuit=circuit,
            cx_steps=x_time_steps,
            control_qubits=x_measure_qubits,
            target_qubits=data_qubits,
            all_active_qubits=x_measure_and_data,
            inactive_measure_qubits=z_measure_qubits,
            after_cx_depolarization=after_clifford_depolarization,
            idle_active_qubits_during_cx_depolarization=idle_during_clifford_depolarization,
            idle_inactive_qubits_during_cx_depolarization=idle_inactive_measure_qubits_during_clifford_depolarization,
        )
        _append_cycle_cx_gates_from_steps(  # Z stabilizers
            circuit=circuit,
            cx_steps=z_time_steps,
            control_qubits=data_qubits,
            target_qubits=z_measure_qubits,
            all_active_qubits=z_measure_and_data,
            inactive_measure_qubits=x_measure_qubits,
            after_cx_depolarization=after_clifford_depolarization,
            idle_active_qubits_during_cx_depolarization=idle_during_clifford_depolarization,
            idle_inactive_qubits_during_cx_depolarization=idle_inactive_measure_qubits_during_clifford_depolarization,
        )
        circuit.append(
            "MX",
            targets=list(x_measure_qubits),
            arg=before_measure_flip_probability,
        )
        circuit.append(
            "MZ",
            targets=list(z_measure_qubits),
            arg=before_measure_flip_probability,
        )
        circuit.append("TICK")

    opp_basis = "X" if basis == "Z" else "Z"

    head = stim.Circuit()
    for i in range(n + rx + rz):
        head.append(
            "QUBIT_COORDS",
            targets=i,
            arg=qubit_coord_func(i) if qubit_coord_func is not None else i,
        )
    head.append(f"R{basis}", data_qubits)
    if after_reset_flip_probability > 0:
        head.append(
            f"{opp_basis}_ERROR",
            targets=data_qubits,
            arg=after_reset_flip_probability,
        )
    append_cycle_gates_both_bases(head)

    offset = -rx - rz if basis == "X" else -rz
    r = rx if basis == "X" else rz
    for i in range(r):
        qubit_idx = basis_measure_qubit_offset + i
        head.append(
            "DETECTOR",
            targets=[stim.target_rec(offset + i)],
            arg=detector_coord_func(qubit_idx)
            if detector_coord_func is not None
            else [qubit_idx, 0],
        )

    body = stim.Circuit()
    append_cycle_gates_both_bases(body)
    body.append("SHIFT_COORDS", arg=shift_coords_per_round)
    if basis == "X" or include_opposite_basis_detectors:
        for i in range(rx):
            qubit_idx = n + i
            body.append(
                "DETECTOR",
                targets=[
                    stim.target_rec(-2 * rx - 2 * rz + i),
                    stim.target_rec(-rx - rz + i),
                ],
                arg=detector_coord_func(qubit_idx)
                if detector_coord_func is not None
                else [qubit_idx, 0],
            )
    if basis == "Z" or include_opposite_basis_detectors:
        for i in range(rz):
            qubit_idx = n + rx + i
            body.append(
                "DETECTOR",
                targets=[
                    stim.target_rec(-2 * rz - rx + i),
                    stim.target_rec(-rz + i),
                ],
                arg=detector_coord_func(qubit_idx)
                if detector_coord_func is not None
                else [qubit_idx, 0],
            )

    tail = stim.Circuit()
    tail.append(
        f"M{basis}", targets=data_qubits, arg=before_measure_flip_probability
    )
    H = x_stabilizers if basis == "X" else z_stabilizers
    for i in range(H.shape[0]):
        qubit_idx = basis_measure_qubit_offset + i
        targets = [stim.target_rec(offset - n + i)]
        for j in H.indices[H.indptr[i] : H.indptr[i + 1]]:
            targets.append(stim.target_rec(-n + j))
        tail.append(
            "DETECTOR",
            targets=targets,
            arg=detector_coord_func(qubit_idx)
            if detector_coord_func is not None
            else [qubit_idx, 0],
        )
    L = x_logicals if basis == "X" else z_logicals
    for i in range(L.shape[0]):
        targets = [
            stim.target_rec(-n + j)
            for j in L.indices[L.indptr[i] : L.indptr[i + 1]]
        ]
        tail.append("OBSERVABLE_INCLUDE", targets=targets, arg=i)

    return head + (num_rounds - 1) * body + tail
