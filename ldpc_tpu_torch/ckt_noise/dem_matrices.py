"""Detector-error-model -> check-matrix conversion, a copy of
``ldpc_tpu.ckt_noise.dem_matrices`` (reference: src_python/ldpc/ckt_noise/dem_matrices.py, after
stimbposd's dem_to_matrices).

Works with any object implementing the ``stim.DetectorErrorModel``
instruction interface (``flattened()``, ``num_detectors``,
``num_observables``) — stim itself is not imported, so the conversion is
usable (and testable) without it.
"""

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Tuple

import numpy as np
from scipy.sparse import csc_matrix


def iter_set_xor(set_list: List[List[int]]) -> FrozenSet[int]:
    """Symmetric difference across a list of index lists
    (reference: dem_matrices.py:10-15)."""
    out = set()
    for x in set_list:
        s = set(x)
        out = (out - s) | (s - out)
    return frozenset(out)


def dict_to_csc_matrix(
    elements_dict: Dict[int, FrozenSet[int]], shape: Tuple[int, int]
) -> csc_matrix:
    """Build a csc matrix from {column: frozenset(nonzero rows)}
    (reference: dem_matrices.py:18-48)."""
    nnz = sum(len(v) for v in elements_dict.values())
    data = np.ones(nnz, dtype=np.uint8)
    row_ind = np.zeros(nnz, dtype=np.int64)
    col_ind = np.zeros(nnz, dtype=np.int64)
    i = 0
    for col, rows in elements_dict.items():
        for row in rows:
            row_ind[i] = row
            col_ind[i] = col
            i += 1
    return csc_matrix((data, (row_ind, col_ind)), shape=shape)


@dataclass
class DemMatrices:
    """(reference: dem_matrices.py:51-58)"""

    check_matrix: csc_matrix
    observables_matrix: csc_matrix
    edge_check_matrix: csc_matrix
    edge_observables_matrix: csc_matrix
    hyperedge_to_edge_matrix: csc_matrix
    priors: np.ndarray


def detector_error_model_to_check_matrices(
    dem, allow_undecomposed_hyperedges: bool = False
) -> DemMatrices:
    """Convert a detector error model into check/observable matrices and
    per-mechanism priors (reference: dem_matrices.py:61-171).

    Error mechanisms triggering the same detector set merge, with priors
    compounding as p <- p(1-q) + q(1-p); each mechanism's decomposition
    into (<=2)-detector edges populates the edge matrices.
    """
    hyperedge_ids: Dict[FrozenSet[int], int] = {}
    edge_ids: Dict[FrozenSet[int], int] = {}
    hyperedge_obs_map: Dict[int, FrozenSet[int]] = {}
    edge_obs_map: Dict[int, FrozenSet[int]] = {}
    priors_dict: Dict[int, float] = {}
    hyperedge_to_edge: Dict[int, FrozenSet[int]] = {}

    def handle_error(prob, detectors, observables):
        hyperedge_dets = iter_set_xor(detectors)
        hyperedge_obs = iter_set_xor(observables)
        if hyperedge_dets not in hyperedge_ids:
            hyperedge_ids[hyperedge_dets] = len(hyperedge_ids)
            priors_dict[hyperedge_ids[hyperedge_dets]] = 0.0
        hid = hyperedge_ids[hyperedge_dets]
        hyperedge_obs_map[hid] = hyperedge_obs
        priors_dict[hid] = priors_dict[hid] * (1 - prob) + prob * (
            1 - priors_dict[hid]
        )
        eids = []
        for dets, obs in zip(detectors, observables):
            e_dets = frozenset(dets)
            e_obs = frozenset(obs)
            if len(e_dets) > 2:
                if not allow_undecomposed_hyperedges:
                    raise ValueError(
                        "A hyperedge error mechanism was found that was not "
                        "decomposed into edges. This can happen if you do "
                        "not set `decompose_errors=True` as required when "
                        "calling `circuit.detector_error_model`."
                    )
                continue
            if e_dets not in edge_ids:
                edge_ids[e_dets] = len(edge_ids)
            eid = edge_ids[e_dets]
            eids.append(eid)
            edge_obs_map[eid] = e_obs
        if hid not in hyperedge_to_edge:
            hyperedge_to_edge[hid] = frozenset(eids)

    for instruction in dem.flattened():
        if instruction.type == "error":
            dets: List[List[int]] = [[]]
            frames: List[List[int]] = [[]]
            p = instruction.args_copy()[0]
            for t in instruction.targets_copy():
                if t.is_relative_detector_id():
                    dets[-1].append(t.val)
                elif t.is_logical_observable_id():
                    frames[-1].append(t.val)
                elif t.is_separator():
                    dets.append([])
                    frames.append([])
            handle_error(p, dets, frames)
        elif instruction.type in ("detector", "logical_observable"):
            pass
        else:
            raise NotImplementedError()

    check_matrix = dict_to_csc_matrix(
        {v: k for k, v in hyperedge_ids.items()},
        shape=(dem.num_detectors, len(hyperedge_ids)),
    )
    observables_matrix = dict_to_csc_matrix(
        hyperedge_obs_map, shape=(dem.num_observables, len(hyperedge_ids))
    )
    priors = np.zeros(len(hyperedge_ids))
    for i, p in priors_dict.items():
        priors[i] = p
    hyperedge_to_edge_matrix = dict_to_csc_matrix(
        hyperedge_to_edge, shape=(len(edge_ids), len(hyperedge_ids))
    )
    edge_check_matrix = dict_to_csc_matrix(
        {v: k for k, v in edge_ids.items()},
        shape=(dem.num_detectors, len(edge_ids)),
    )
    edge_observables_matrix = dict_to_csc_matrix(
        edge_obs_map, shape=(dem.num_observables, len(edge_ids))
    )
    return DemMatrices(
        check_matrix=check_matrix,
        observables_matrix=observables_matrix,
        edge_check_matrix=edge_check_matrix,
        edge_observables_matrix=edge_observables_matrix,
        hyperedge_to_edge_matrix=hyperedge_to_edge_matrix,
        priors=priors,
    )
