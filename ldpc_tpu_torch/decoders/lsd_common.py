"""Shared LSD statistics objects and method aliasing.

Port of ``ldpc_tpu.decoders.lsd_common``, which cannot be imported here
because it imports ``ldpc_tpu.ops.lsd`` and with it jax. Mirrors the
reference's LSD ``Statistics`` / ``ClusterStatistics`` schema (reference:
src_cpp/lsd.hpp:464-603) as plain Python dataclasses; the JSON field names
match the reference's serializer so downstream tooling can consume either.
"""

import dataclasses
import json
from typing import Dict, List

from ldpc_tpu_torch.ops import lsd as lsd_ops

METHOD_NAMES = {
    lsd_ops.LSD_0: "LSD_0",
    lsd_ops.LSD_E: "LSD_E",
    lsd_ops.LSD_CS: "LSD_CS",
    -1: "LSD_OFF",
}


def parse_lsd_method(method) -> int:
    sval = str(method).lower()
    if sval in ("osd_0", "0", "osd0", "lsd_0", "lsd0"):
        return lsd_ops.LSD_0
    if sval in ("osd_e", "e", "exhaustive", "lsd_e", "lsde"):
        return lsd_ops.LSD_E
    if sval in ("osd_cs", "1", "cs", "combination_sweep", "lsd_cs", "lsdcs"):
        return lsd_ops.LSD_CS
    if sval in ("off", "osd_off", "deactivated", "-1", "lsd_off"):
        return -1
    raise ValueError(
        f"ERROR: OSD method '{method}' invalid. Please choose from the "
        "following methods: 'LSD_0', 'LSD_E' or 'LSD_CS'."
    )


@dataclasses.dataclass
class ClusterStatistics:
    """Per-cluster record (lsd.hpp:464-478)."""

    final_bit_count: int = 0
    undergone_growth_steps: int = 0
    nr_merges: int = 0
    got_valid_in_timestep: int = -1
    got_inactive_in_timestep: int = -1
    absorbed_by_cluster: int = -1
    nr_of_non_zero_check_matrix_entries: int = 0
    cluster_pcm_sparsity: float = 0.0
    active: bool = False
    size_history: List[int] = dataclasses.field(default_factory=list)
    solution: List[int] = dataclasses.field(default_factory=list)
    final_bits: List[int] = dataclasses.field(default_factory=list)
    cluster_id: int = -1


@dataclasses.dataclass
class Statistics:
    """Global decode record (lsd.hpp:492-603)."""

    elapsed_time: float = 0.0
    lsd_order: int = 0
    lsd_method: int = 0
    individual_cluster_stats: Dict[int, ClusterStatistics] = dataclasses.field(
        default_factory=dict
    )
    global_timestep_bit_history: Dict[int, Dict[int, List[int]]] = (
        dataclasses.field(default_factory=dict)
    )
    bit_llrs: List[float] = dataclasses.field(default_factory=list)
    syndrome: List[int] = dataclasses.field(default_factory=list)
    error: List[int] = dataclasses.field(default_factory=list)
    compare_recover: List[int] = dataclasses.field(default_factory=list)
    # which batch row the record describes (the reference only ever
    # decodes one syndrome per call)
    stats_row: int = 0

    def __getitem__(self, key: str):
        """Dict-style access for parity with the reference's ``statistics``
        property, which converts the C++ struct to a dict
        (_bplsd_decoder.pyx:174-182)."""
        return getattr(self, key)

    def clear(self) -> None:
        self.individual_cluster_stats.clear()
        self.global_timestep_bit_history.clear()
        self.bit_llrs = []
        self.syndrome = []
        self.error = []
        self.compare_recover = []
        self.elapsed_time = 0.0

    def to_json(self) -> str:
        """JSON export with the reference serializer's field names
        (lsd.hpp:504-603: top-level ``elapsed_time_mu``; cluster maps
        keyed by stringified ids)."""
        d = dataclasses.asdict(self)
        d["elapsed_time_mu"] = d.pop("elapsed_time")
        d["individual_cluster_stats"] = {
            str(k): v for k, v in d["individual_cluster_stats"].items()
        }
        d["global_timestep_bit_history"] = {
            str(t): {str(c): bits for c, bits in per.items()}
            for t, per in d["global_timestep_bit_history"].items()
        }
        return json.dumps(d)
