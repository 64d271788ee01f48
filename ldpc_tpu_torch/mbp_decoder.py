"""Import-path parity with ``ldpc.mbp_decoder``
(reference: src_python/ldpc/mbp_decoder/__init__.py)."""

import sys as _sys
import types as _types

from ldpc_tpu_torch.decoders.mbp_decoder import MbpDecoder, mbp_decoder  # noqa: F401


class _CallableModule(_types.ModuleType):
    """Keep ``ldpc_tpu_torch.mbp_decoder`` callable as the decoder class:
    importing this module replaces the package's ``mbp_decoder`` alias of
    the class with the module."""

    def __call__(self, *args, **kwargs):
        return MbpDecoder(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule
