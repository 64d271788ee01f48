"""Cross-cutting utilities (profiling, observability)."""

from ldpc_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer,
    annotate,
    profile_decode,
    trace,
)

__all__ = ["StageTimer", "annotate", "profile_decode", "trace"]
