"""ldpc_tpu_torch: the PyTorch/CUDA port of ``ldpc_tpu``.

A second package beside the JAX one, with the same public decoder API.
Plain tensor code is PyTorch; every kernel (BP, the GF(2) eliminations of
OSD-0, OSD-E/CS, LSD and union-find, and the flip sweep) is hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and
launched through ``ctypes``. Tensors on the CPU run each kernel's plain
PyTorch version instead.

Importing the package builds nothing and initialises no CUDA context. The
JAX-free host modules of ``ldpc_tpu`` (codes, helpers, mod2, the PCM
compiler) are imported, not copied; ``jax`` is never imported.
"""

__version__ = "0.1.0"

from ldpc_tpu_torch import codes  # noqa: F401
from ldpc_tpu_torch.decoders.belief_find import BeliefFindDecoder
from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder
from ldpc_tpu_torch.decoders.bp_flip import BpFlipDecoder, FlipDecoder
from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder
from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder
from ldpc_tpu_torch.decoders.lsd_decoder import LsdDecoder
from ldpc_tpu_torch.decoders.union_find import UnionFindDecoder

__all__ = [
    "BeliefFindDecoder",
    "BpDecoder",
    "BpFlipDecoder",
    "BpLsdDecoder",
    "BpOsdDecoder",
    "FlipDecoder",
    "LsdDecoder",
    "UnionFindDecoder",
    "codes",
    "__version__",
]
