"""ldpc_tpu_torch: the PyTorch/CUDA port of ``ldpc_tpu``.

A second package beside the JAX one, with the same public decoder API.
Plain tensor code is PyTorch; every kernel (parallel BP; serial,
soft-information and fold-exact BP; the GF(2) eliminations of OSD-0,
OSD-E/CS, LSD and union-find; and the flip sweep) is hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and
launched through ``ctypes``.

Every decoder and factory runs on the CUDA device unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead;
without a CUDA device the default raises (:mod:`ldpc_tpu_torch.device`).

Importing the package builds nothing and initialises no CUDA context. The
package imports nothing of ``ldpc_tpu`` and never ``jax``: its host modules
(code constructions, input validation, the GF(2) toolbox ``mod2``, the
code utilities, alist files, protographs, the noise models and the PCM
compiler) are its own copies, in ``codes/``, ``helpers.py``, ``mod2/``,
``code_util/``, ``alist.py``, ``protograph.py``, ``noise_models/`` and
``ops/pcm.py``; ``alist``, ``code_util``, ``noise_models`` and
``protograph`` load on first use.
"""

__version__ = "0.1.0"

from ldpc_tpu_torch import codes, helpers, mod2  # noqa: F401
from ldpc_tpu_torch.decoders.belief_find import BeliefFindDecoder
from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder, SoftInfoBpDecoder
from ldpc_tpu_torch.decoders.bp_flip import BpFlipDecoder, FlipDecoder
from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder
from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder, SoftInfoBpOsdDecoder
from ldpc_tpu_torch.decoders.lsd_decoder import LsdDecoder
from ldpc_tpu_torch.decoders.mbp_decoder import MbpDecoder, mbp_decoder
from ldpc_tpu_torch.decoders.union_find import UnionFindDecoder

_LAZY_SUBMODULES = ("alist", "code_util", "noise_models", "protograph")


def __getattr__(name):
    """The host submodules, imported on first use."""
    import importlib

    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"ldpc_tpu_torch.{name}")
    raise AttributeError(f"module 'ldpc_tpu_torch' has no attribute '{name}'")


__all__ = [
    "BeliefFindDecoder",
    "BpDecoder",
    "BpFlipDecoder",
    "BpLsdDecoder",
    "BpOsdDecoder",
    "FlipDecoder",
    "LsdDecoder",
    "MbpDecoder",
    "SoftInfoBpDecoder",
    "SoftInfoBpOsdDecoder",
    "UnionFindDecoder",
    "codes",
    "helpers",
    "mbp_decoder",
    "mod2",
    "__version__",
    *_LAZY_SUBMODULES,
]
