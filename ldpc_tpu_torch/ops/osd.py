"""Batched ordered-statistics decoding (port of ``ldpc_tpu.ops.osd``, order 0).

OSD-0 takes each lane's columns least-reliable-first (a stable argsort of
the BP posterior LLRs, done here outside the kernel) and solves H x = s by
Gauss-Jordan elimination in that order (:mod:`ldpc_tpu_torch.ops.gf2_cuda`).
Higher orders (OSD-E, OSD-CS) are ROADMAP queue 1 item 8.
"""

import numpy as np
import torch

from ldpc_tpu.ops.pcm import PcmGraph
from ldpc_tpu_torch.ops import gf2, gf2_cuda
from ldpc_tpu_torch.ops.pcm import graph_to_torch

OSD_OFF = -1
OSD_0 = 0
EXHAUSTIVE = 1
COMBINATION_SWEEP = 2


def make_osd_decoder(
    graph: PcmGraph,
    channel: np.ndarray,
    osd_method: int,
    osd_order: int,
    device,
):
    """Build a batched OSD decoder on ``device``.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n) float32) ->
    (osd0: (B, n) uint8, osdw: (B, n) uint8, valid: (B,) bool)``; at order
    0 the two decodings are the same tensor. ``channel`` only weighs the
    candidates of higher orders.
    """
    rank = gf2.batched_rank(graph.dense)
    k = graph.n - rank
    order0 = osd_method in (OSD_0, OSD_OFF) or osd_order == 0 or k == 0
    if not order0:
        raise NotImplementedError(
            "OSD-E and OSD-CS above order 0 are not ported yet "
            "(ROADMAP queue 1 item 8)"
        )
    tg = graph_to_torch(graph, device)
    device = torch.device(device)

    def decode(syndromes: torch.Tensor, llrs: torch.Tensor):
        syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device)
        llrs = torch.as_tensor(llrs, dtype=torch.float32, device=device)
        # least-reliable-first; stable, as the reference's qsort is on
        # distinct keys
        order = torch.argsort(llrs, dim=1, stable=True).to(torch.int32)
        x0, valid = gf2_cuda.osd0(
            tg, syndromes.contiguous(), order.contiguous(), rank
        )
        return x0, x0, valid

    return decode
