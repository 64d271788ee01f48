"""Import-path parity with ``ldpc.bposd_decoder``
(reference: src_python/ldpc/bposd_decoder/__init__.py)."""

import sys as _sys
import types as _types

from ldpc_tpu_torch.decoders.bposd_decoder import (  # noqa: F401
    BpOsdDecoder,
    SoftInfoBpOsdDecoder,
)
from ldpc_tpu_torch._legacy_v1 import bposd_decoder  # noqa: F401


class _CallableModule(_types.ModuleType):
    """Keep ``ldpc_tpu_torch.bposd_decoder`` callable as the legacy v1 class
    after this module shadows the root attribute (see bp_decoder.py)."""

    def __call__(self, *args, **kwargs):
        return bposd_decoder(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule
