"""Circuit-level noise tooling: DEM conversion, overlapping-window
decoding, CSS memory-circuit generation.

Port of ``ldpc_tpu.ckt_noise`` (API parity with ``ldpc.ckt_noise``,
reference: src_python/ldpc/ckt_noise/). stim-, sinter- and
pymatching-dependent entry points import them lazily so the rest of the
package works without them. The decoders run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from ldpc_tpu_torch.ckt_noise.dem_matrices import (  # noqa: F401
    DemMatrices,
    detector_error_model_to_check_matrices,
)
from ldpc_tpu_torch.ckt_noise.bipartite_edge_coloring import (  # noqa: F401
    BipartiteGraph,
    Node,
    bipartite_edge_coloring,
    is_valid_bipartite_edge_coloring,
)
from ldpc_tpu_torch.ckt_noise.pymatching_overlapping_window import (  # noqa: F401
    PyMatchingOverlappingWindowDecoder,
)
from ldpc_tpu_torch.ckt_noise import not_an_arb_ckt_simulator  # noqa: F401
from ldpc_tpu_torch.ckt_noise.base_overlapping_window_decoder import (  # noqa: F401
    BaseOverlappingWindowDecoder,
    current_round_inds,
)
from ldpc_tpu_torch.ckt_noise.bposd_overlapping_window import (  # noqa: F401
    BpOsdOverlappingWindowDecoder,
)
from ldpc_tpu_torch.ckt_noise.lsd_overlapping_window import (  # noqa: F401
    LsdOverlappingWindowDecoder,
)


def __getattr__(name):
    """Lazy stim-dependent entry points (stim is optional)."""
    if name == "make_css_code_memory_circuit":
        from ldpc_tpu_torch.ckt_noise.css_code_memory_circuit import (
            make_css_code_memory_circuit,
        )

        return make_css_code_memory_circuit
    raise AttributeError(
        f"module 'ldpc_tpu_torch.ckt_noise' has no attribute '{name}'"
    )


__all__ = [
    "DemMatrices",
    "detector_error_model_to_check_matrices",
    "BipartiteGraph",
    "Node",
    "bipartite_edge_coloring",
    "is_valid_bipartite_edge_coloring",
    "BaseOverlappingWindowDecoder",
    "current_round_inds",
    "BpOsdOverlappingWindowDecoder",
    "LsdOverlappingWindowDecoder",
    "PyMatchingOverlappingWindowDecoder",
    "make_css_code_memory_circuit",
    "not_an_arb_ckt_simulator",
]
