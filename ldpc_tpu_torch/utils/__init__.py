"""Cross-cutting utilities (profiling, observability)."""

from ldpc_tpu_torch.utils.profiling import (  # noqa: F401
    NULL_SPAN,
    Recording,
    Span,
    StageTimer,
    annotate,
    count,
    drain,
    profile_decode,
    record,
    span,
    sync,
    trace,
)

__all__ = ["NULL_SPAN", "Recording", "Span", "StageTimer", "annotate", "count", "drain",
           "profile_decode", "record", "span", "sync", "trace"]
