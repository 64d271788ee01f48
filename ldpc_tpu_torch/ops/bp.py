"""Batched parallel-schedule belief propagation (port of ``ldpc_tpu.ops.bp``).

Holds the method and schedule constants, the batch-major result type, the
channel LLRs and the decoder builder. The message passing itself lives in
:mod:`ldpc_tpu_torch.ops.bp_cuda`: kernel K1' on a CUDA device, its plain
PyTorch version on the CPU.
"""

from typing import NamedTuple

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops.pcm import PcmGraph

PRODUCT_SUM = 0
MINIMUM_SUM = 1

PARALLEL = 1
SERIAL = 0
SERIAL_RELATIVE = 2


class BpResult(NamedTuple):
    """Batched BP outputs, batch-major at the API boundary."""

    decoding: torch.Tensor  # (B, n) uint8
    llr_posterior: torch.Tensor  # (B, n) float32
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int32


def channel_llr(error_channel: np.ndarray, dtype=np.float32) -> np.ndarray:
    """log((1-p)/p) per bit; p=0 gives +inf ("certainly not flipped")."""
    p = np.asarray(error_channel, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return (np.log((1.0 - p) / p)).astype(dtype)


def make_parallel_decoder(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    device,
):
    """Build a batched parallel-schedule BP decoder on ``device``.

    Returns ``decode(syndromes: (B, m) uint8, init_llr: (n,) float32) ->
    BpResult``. Each lane stops at its first convergence; the decision,
    posterior and iteration count are those of that iteration (or of
    ``max_iter``). float32 only: the float64 exact mode is ROADMAP queue 1
    item 12.
    """
    from ldpc_tpu_torch.ops import bp_cuda
    from ldpc_tpu_torch.ops.pcm import graph_to_torch

    device = resolve_device(device)
    tg = graph_to_torch(graph, device)

    def decode(syndromes: torch.Tensor, init_llr: torch.Tensor) -> BpResult:
        syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device)
        init_llr = torch.as_tensor(init_llr, dtype=torch.float32, device=device)
        return bp_cuda.bp_parallel(
            tg,
            syndromes.contiguous(),
            init_llr.contiguous(),
            bp_method,
            max_iter,
            ms_scaling_factor,
        )

    return decode
