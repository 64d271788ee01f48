"""ldpc_tpu_torch: the PyTorch/CUDA port of ``ldpc_tpu``.

A second package beside the JAX one, with the same public decoder API.
Plain tensor code is PyTorch; every kernel (BP, and the GF(2)
eliminations of OSD-0, OSD-E/CS and LSD) is hand-written CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use and launched through
``ctypes``. Tensors on the CPU run each kernel's plain PyTorch version
instead.

Importing the package builds nothing and initialises no CUDA context. The
JAX-free host modules of ``ldpc_tpu`` (codes, helpers, mod2, the PCM
compiler) are imported, not copied; ``jax`` is never imported.
"""

__version__ = "0.1.0"

from ldpc_tpu_torch import codes  # noqa: F401
from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder
from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder
from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder

__all__ = ["BpDecoder", "BpLsdDecoder", "BpOsdDecoder", "codes", "__version__"]
