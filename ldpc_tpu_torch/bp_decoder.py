"""Import-path parity with ``ldpc.bp_decoder``
(reference: src_python/ldpc/bp_decoder/__init__.py): reference users can
switch by renaming only the top-level package."""

import sys as _sys
import types as _types

from ldpc_tpu_torch.decoders.base import BpDecoderBase  # noqa: F401
from ldpc_tpu_torch.decoders.bp_decoder import (  # noqa: F401
    BpDecoder,
    SoftInfoBpDecoder,
)
from ldpc_tpu_torch.mod2 import io_test  # noqa: F401
from ldpc_tpu_torch._legacy_v1 import bp_decoder  # noqa: F401


class _CallableModule(_types.ModuleType):
    """Importing this module rebinds ``ldpc_tpu_torch.bp_decoder`` from the
    legacy v1 class (root ``__getattr__``) to the module object; the
    reference keeps the name callable either way
    (reference: src_python/ldpc/__init__.py:14), so calling the module
    constructs the legacy decoder."""

    def __call__(self, *args, **kwargs):
        return bp_decoder(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule
