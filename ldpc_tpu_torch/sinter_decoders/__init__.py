"""sinter decoder adapters (port of ``ldpc_tpu.sinter_decoders``;
reference: src_python/ldpc/sinter_decoders/).

sinter and stim are optional dependencies: the classes import lazily and
degrade to informative errors when absent. Each adapter takes ``device``.
"""

from ldpc_tpu_torch.sinter_decoders.sinter_decoders import (  # noqa: F401
    SinterBeliefFindDecoder,
    SinterBpOsdDecoder,
    SinterLsdDecoder,
)

__all__ = [
    "SinterBpOsdDecoder",
    "SinterLsdDecoder",
    "SinterBeliefFindDecoder",
]
