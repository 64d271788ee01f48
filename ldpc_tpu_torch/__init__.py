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
package imports nothing of ``ldpc_tpu`` and never ``jax``: the host modules
it needs (code constructions, input validation, host GF(2) rank and kernel,
the PCM compiler) are its own copies, in ``codes/``, ``helpers.py``,
``mod2.py`` and ``ops/pcm.py``.
"""

__version__ = "0.1.0"

from ldpc_tpu_torch import codes  # noqa: F401
from ldpc_tpu_torch.decoders.belief_find import BeliefFindDecoder
from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder, SoftInfoBpDecoder
from ldpc_tpu_torch.decoders.bp_flip import BpFlipDecoder, FlipDecoder
from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder
from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder, SoftInfoBpOsdDecoder
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
    "SoftInfoBpDecoder",
    "SoftInfoBpOsdDecoder",
    "UnionFindDecoder",
    "codes",
    "__version__",
]
