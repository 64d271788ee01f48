"""Multi-device decoding (port of ``ldpc_tpu.parallel``): the mesh and its
batch-axis helpers, multi-process initialisation, window decoding along the
rounds axis (on one device, or sharded over a mesh), check-sharded
(tensor-parallel) BP and the BP -> OSD-0 pipeline.

JAX expresses all of it through ``jax.sharding`` over one SPMD program. The
port keeps a small :class:`~ldpc_tpu_torch.parallel.sharding.Mesh` of
``torch.device`` entries (repeats allowed: ``devices=["cpu"] * 2`` or
``["cuda:0", "cuda:0"]``) and launches each entry's work on its device;
across processes it wraps ``torch.distributed`` (:func:`initialize_distributed`).
"""

from ldpc_tpu_torch.parallel.sharding import (  # noqa: F401
    BATCH_AXIS,
    Mesh,
    make_mesh,
    shard_batch,
    replicate,
    unshard,
    psum_tally,
)
from ldpc_tpu_torch.parallel.distributed import (  # noqa: F401
    global_device_count,
    initialize as initialize_distributed,
    is_distributed,
    local_device_count,
    process_count,
)
from ldpc_tpu_torch.parallel.window import (  # noqa: F401
    ROUNDS_AXIS,
    WindowDecodeResult,
    make_rounds_sharded_window_decoder,
    make_window_decoder,
)
from ldpc_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    CODE_AXIS,
    TpBpDecoder,
    make_tp_bp_decoder,
)
from ldpc_tpu_torch.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS,
    make_pipeline_mesh,
    make_pipelined_decoder,
)

__all__ = [
    "BATCH_AXIS",
    "ROUNDS_AXIS",
    "Mesh",
    "WindowDecodeResult",
    "make_mesh",
    "shard_batch",
    "replicate",
    "unshard",
    "psum_tally",
    "make_window_decoder",
    "make_rounds_sharded_window_decoder",
    "CODE_AXIS",
    "TpBpDecoder",
    "make_tp_bp_decoder",
    "STAGE_AXIS",
    "make_pipeline_mesh",
    "make_pipelined_decoder",
    "initialize_distributed",
    "is_distributed",
    "process_count",
    "local_device_count",
    "global_device_count",
]
