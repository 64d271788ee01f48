"""Code constructions, re-exported from the JAX-free ``ldpc_tpu.codes``."""

from ldpc_tpu.codes import *  # noqa: F401,F403
from ldpc_tpu.codes import __all__  # noqa: F401
