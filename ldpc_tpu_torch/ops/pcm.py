"""The parity-check matrix as device tensors.

The JAX package compiles a PCM once into padded ELL index arrays
(``ldpc_tpu.ops.pcm.compile_pcm``); this module moves that layout onto a
torch device. Together with the channel LLRs it is the only state a
decoder carries. The pad conventions are kept: a pad slot of ``chk_bits``
points at bit ``n``, a pad slot of ``var_edges`` at edge ``m * dc`` and a
pad slot of ``var_chks`` at check ``m``.
"""

from typing import NamedTuple

import numpy as np
import torch

from ldpc_tpu.ops.pcm import PcmGraph, compile_pcm  # noqa: F401 (re-export)
from ldpc_tpu_torch.ops.gf2 import pack_u32


class TorchGraph(NamedTuple):
    """Device layout of a parity-check matrix."""

    m: int  # checks
    n: int  # bits
    dc: int  # max check (row) degree
    dv: int  # max variable (column) degree
    chk_bits: torch.Tensor  # (m, dc) int32, bit of each slot, pad = n
    chk_mask: torch.Tensor  # (m, dc) bool
    var_edges: torch.Tensor  # (n, dv) int32, edge id check*dc+slot, pad = m*dc
    var_chks: torch.Tensor  # (n, dv) int32, check of each slot, pad = m
    var_mask: torch.Tensor  # (n, dv) bool
    dense: torch.Tensor  # (m, n) uint8
    # [H | 0] packed LSB-first: (m, ceil((n+1)/32)) int32 words, so the
    # syndrome column n fits beside H for the OSD-0 elimination
    packed: torch.Tensor

    @property
    def num_edges(self) -> int:
        return self.m * self.dc


def graph_to_torch(graph: PcmGraph, device) -> TorchGraph:
    """Copy a compiled :class:`PcmGraph` onto ``device``."""
    dense = torch.from_numpy(np.ascontiguousarray(graph.dense, np.uint8))
    aug = torch.nn.functional.pad(dense, (0, 1))  # room for the syndrome bit

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype
        )

    return TorchGraph(
        m=graph.m,
        n=graph.n,
        dc=graph.dc,
        dv=graph.dv,
        chk_bits=put(graph.chk_bits, torch.int32),
        chk_mask=put(graph.chk_mask, torch.bool),
        var_edges=put(graph.var_edges, torch.int32),
        var_chks=put(graph.var_chks, torch.int32),
        var_mask=put(graph.var_mask, torch.bool),
        dense=dense.to(device),
        packed=pack_u32(aug).contiguous().to(device),
    )
