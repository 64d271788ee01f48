"""The parity-check matrix as padded index arrays, on the host and on a
torch device.

:func:`compile_pcm` builds the padded ELL layout once per code, on the
host (numpy), exactly as the JAX package's PCM compiler does;
:func:`graph_to_torch` moves it onto a torch device. Together with the
channel LLRs it is the only state a decoder carries. The pad conventions:
a pad slot of ``chk_bits`` points at bit ``n``, a pad slot of
``var_edges`` at edge ``m * dc`` and a pad slot of ``var_chks`` at check
``m``.

- check-major edges: edge ``e = check*dc + slot`` with ``bit_of_edge[e]``
  giving the column;
- variable-major views: for each bit, the flat check-major edge ids of its
  column (``var_edges``), the owning check (``var_chks``) and the slot of
  the bit within that check's row (``var_slot``).
"""

from typing import NamedTuple

import numpy as np
import torch

from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops.gf2 import pack_u32


class PcmGraph(NamedTuple):
    """Host layout of a parity-check matrix (numpy arrays)."""

    m: int  # checks
    n: int  # bits
    dc: int  # max check (row) degree
    dv: int  # max variable (column) degree
    nnz: int
    # check-major ELL --------------------------------------------------
    chk_bits: np.ndarray  # (m, dc) int32, bit index per slot, pad = n
    chk_mask: np.ndarray  # (m, dc) bool
    # variable-major views over check-major edge ids --------------------
    var_edges: np.ndarray  # (n, dv) int32, flat edge id (check*dc+slot), pad = m*dc
    var_chks: np.ndarray  # (n, dv) int32, check index, pad = m
    var_mask: np.ndarray  # (n, dv) bool
    bit_of_edge: np.ndarray  # (m*dc,) int32, pad = n
    chk_of_edge: np.ndarray  # (m*dc,) int32, pad = m
    # slot of each bit within the rows of its checks (for serial schedules)
    var_slot: np.ndarray  # (n, dv) int32, pad = 0
    dense: np.ndarray  # (m, n) uint8

    @property
    def num_edges(self) -> int:
        return self.m * self.dc


def compile_pcm(pcm) -> PcmGraph:
    """Build the padded ELL layout from a scipy-sparse/numpy PCM."""
    pcm = convert_to_binary_sparse(pcm).tocsr()
    pcm.sort_indices()
    m, n = pcm.shape
    indptr, indices = pcm.indptr, pcm.indices
    row_deg = np.diff(indptr)
    dc = int(row_deg.max()) if m else 0
    col_deg = np.bincount(indices, minlength=n)
    dv = int(col_deg.max()) if n else 0
    if (col_deg == 0).any():
        # zero-weight columns are legal for BP (bit never updates) but the
        # UF decoders reject them; keep dv >= 1 for layout sanity
        dv = max(dv, 1)

    chk_bits = np.full((m, dc), n, dtype=np.int32)
    chk_mask = np.zeros((m, dc), dtype=bool)
    for i in range(m):
        row = indices[indptr[i] : indptr[i + 1]]
        chk_bits[i, : row.size] = row
        chk_mask[i, : row.size] = True

    E = m * dc
    bit_of_edge = chk_bits.reshape(-1).astype(np.int32)
    chk_of_edge = np.where(
        chk_mask.reshape(-1), np.repeat(np.arange(m, dtype=np.int32), dc), m
    ).astype(np.int32)

    var_edges = np.full((n, dv), E, dtype=np.int32)
    var_chks = np.full((n, dv), m, dtype=np.int32)
    var_slot = np.zeros((n, dv), dtype=np.int32)
    var_mask = np.zeros((n, dv), dtype=bool)
    fill = np.zeros(n, dtype=np.int64)
    for i in range(m):
        for slot in range(int(row_deg[i])):
            j = chk_bits[i, slot]
            k = fill[j]
            var_edges[j, k] = i * dc + slot
            var_chks[j, k] = i
            var_slot[j, k] = slot
            var_mask[j, k] = True
            fill[j] += 1

    return PcmGraph(
        m=m,
        n=n,
        dc=dc,
        dv=dv,
        nnz=int(pcm.nnz),
        chk_bits=chk_bits,
        chk_mask=chk_mask,
        var_edges=var_edges,
        var_chks=var_chks,
        var_mask=var_mask,
        bit_of_edge=bit_of_edge,
        chk_of_edge=chk_of_edge,
        var_slot=var_slot,
        dense=np.asarray(pcm.todense(), dtype=np.uint8),
    )


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
    # K1's slot-major views, so that a warp's threads owning consecutive
    # checks (bits) read consecutive words: chk_bits transposed, (dc, m);
    # and each bit's edges renumbered slot*m + check, (dv, n), pad = m*dc
    chk_bits_t: torch.Tensor
    var_edges_t: torch.Tensor

    @property
    def num_edges(self) -> int:
        return self.m * self.dc


def _slot_major_edges(graph: PcmGraph) -> np.ndarray:
    """``var_edges`` renumbered from check-major ``check*dc + slot`` to
    slot-major ``slot*m + check`` and transposed to (dv, n); pad stays m*dc."""
    E = graph.m * graph.dc
    e = graph.var_edges.astype(np.int64)
    dc = max(graph.dc, 1)
    out = np.where(e < E, (e % dc) * graph.m + e // dc, E)
    return out.T.astype(np.int32)


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
        chk_bits_t=put(graph.chk_bits.T, torch.int32),
        var_edges_t=put(_slot_major_edges(graph), torch.int32),
    )
