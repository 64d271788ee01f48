"""Tensor (model) parallel BP: the Tanner graph's checks sharded over a
mesh (port of ``ldpc_tpu.parallel.tensor_parallel``).

Data parallelism (the ``batch`` axis) replicates the parity-check matrix
on every device; for very large codes the check-major message arrays
outgrow one device. This module shards the CHECK axis of the Tanner graph
over a ``code`` mesh axis:

- every entry owns ``m/D`` checks (padded with dummy checks up to a
  multiple of D) and their ``(m/D, dc, B)`` message block, so the check
  updates (the min or tanh reductions, the heavy part) are local;
- the bit side is a local scatter-add of the entry's check-to-bit messages
  into an ``(n, B)`` partial — taken as a gather over the entry's own
  bit-to-edge table, in edge order, so the sum is deterministic — and the
  partials are summed once an iteration over the ``code`` axis
  (:func:`~ldpc_tpu_torch.parallel.sharding.psum`): the traffic is the
  posterior, not the edges;
- convergence is a summed syndrome-mismatch count.

A 2-D ``(batch, code)`` mesh composes both: the batch axis splits B, the
code axis splits m, and the sums ride only the ``code`` axis. The JAX
package runs XLA ops here (``ldpc_tpu/ops/bp.py``'s check updates), not a
Pallas kernel; the port is plain PyTorch on its own plain check updates
(``ops/bp_cuda.py``), on any device. One host sync an iteration (the stop
test).
"""

from typing import Optional

import numpy as np
import torch

from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.ops.bp import BpResult, MINIMUM_SUM
from ldpc_tpu_torch.ops.bp_cuda import _check_to_bit_min_sum, _check_to_bit_product_sum
from ldpc_tpu_torch.ops.pcm import PcmGraph, compile_pcm
from ldpc_tpu_torch.parallel.sharding import psum

CODE_AXIS = "code"


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _block_tables(chk_bits: np.ndarray, n: int):
    """A check block's flat edge bits ``(E,)`` (pad n) and its bit-to-edge
    table ``(n, dv)`` in edge order (pad E)."""
    edge_bits = chk_bits.reshape(-1)
    E = edge_bits.size
    real = np.flatnonzero(edge_bits < n)
    deg = np.bincount(edge_bits[real], minlength=n)
    dv = max(int(deg.max()) if n else 0, 1)
    table = np.full((n, dv), E, np.int64)
    fill = np.zeros(n, np.int64)
    for e in real:  # increasing edge index: the scatter-add's order
        b = edge_bits[e]
        table[b, fill[b]] = e
        fill[b] += 1
    return edge_bits.astype(np.int64), table


def make_tp_bp_decoder(
    graph: PcmGraph,
    mesh,
    *,
    bp_method: int = MINIMUM_SUM,
    max_iter: int = 30,
    ms_scaling_factor: float = 0.625,
    axis_name: str = CODE_AXIS,
    batch_axis: Optional[str] = None,
    dtype=torch.float32,
):
    """Build a check-sharded (tensor-parallel) batched BP decoder.

    ``mesh`` must carry ``axis_name``; if ``batch_axis`` is given (or a
    ``batch`` axis exists on the mesh) the syndrome batch is sharded over it
    as well. Returns ``decode(syndromes (B, m) uint8, init_llr (n,) or (B,
    n)) -> BpResult`` on the first entry's device; semantics match
    :func:`ldpc_tpu_torch.ops.bp.make_parallel_decoder` up to the
    floating-point summation order on the bit axis.
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, expected {axis_name!r}")
    if batch_axis is None and "batch" in mesh.axis_names:
        batch_axis = "batch"
    # (DB, D): batch group b, check block c (other axes at index 0)
    axes = [mesh.axis_names.index(batch_axis)] if batch_axis else []
    axes.append(mesh.axis_names.index(axis_name))
    grid = np.moveaxis(mesh.devices, axes, list(range(len(axes))))
    grid = grid.reshape(grid.shape[: len(axes)] + (-1,))[..., 0].reshape(-1, mesh.shape[axis_name])
    DB, D = grid.shape
    dtype = bp_ops.torch_dtype(dtype)

    m, n, dc = graph.m, graph.n, graph.dc
    m_pad = _round_up(m, D)
    m_loc = m_pad // D
    # dummy checks: every slot masked and pointing at the pad bit n,
    # syndrome fixed 0 -> trivially satisfied, contributing 0
    chk_bits = np.full((m_pad, dc), n, np.int32)
    chk_bits[:m] = graph.chk_bits
    chk_mask = np.zeros((m_pad, dc), bool)
    chk_mask[:m] = graph.chk_mask
    blocks = [_block_tables(chk_bits[c * m_loc:(c + 1) * m_loc], n) for c in range(D)]
    local = {}  # (device, block) -> (edge_bits, bit-to-edge table, mask3)
    for b in range(DB):
        for c in range(D):
            dev = grid[b, c]
            if (dev, c) not in local:
                edge_bits, table = blocks[c]
                local[dev, c] = (
                    torch.from_numpy(edge_bits).to(dev),
                    torch.from_numpy(table).to(dev),
                    torch.from_numpy(chk_mask[c * m_loc:(c + 1) * m_loc, :, None]).to(dev),
                )

    def decode(syndromes, init_llr) -> BpResult:
        syndromes = torch.as_tensor(np.asarray(syndromes, np.uint8)
                                    if not isinstance(syndromes, torch.Tensor) else syndromes)
        # pad and split where the syndromes lie; each block goes straight
        # to its entry
        src = syndromes.device
        syndromes = syndromes.to(torch.uint8)
        init_llr = torch.as_tensor(init_llr).to(src, dtype)
        B0 = syndromes.shape[0]
        B = _round_up(B0, DB)
        Bl = B // DB
        syn = torch.zeros((B, m_pad), dtype=torch.int32, device=src)
        syn[:B0, :m] = syndromes
        if init_llr.dim() == 2:
            prior = torch.zeros((B, n), dtype=dtype, device=src)
            prior[:B0] = init_llr
        groups = []
        for b in range(DB):
            rows = slice(b * Bl, (b + 1) * Bl)
            col = prior[rows].t() if init_llr.dim() == 2 else init_llr[:, None]
            entries = []
            for c in range(D):
                dev = grid[b, c]
                llr_col = col.to(dev)
                llr0 = llr_col.expand(n, Bl).contiguous()
                entries.append({
                    "dev": dev, "block": local[dev, c],
                    "syn": syn[rows, c * m_loc:(c + 1) * m_loc].t().contiguous().to(dev),
                    "llr_col": llr_col, "llr_post": llr0,
                    "c2v": torch.zeros((m_loc, dc, Bl), dtype=dtype, device=dev),
                    "conv": torch.zeros(Bl, dtype=torch.bool, device=dev),
                    "dec": torch.zeros((n, Bl), dtype=torch.bool, device=dev),
                    "llr_out": llr0.clone(),
                    "iters": torch.zeros(Bl, dtype=torch.int32, device=dev),
                })
            groups.append(entries)

        it = 0
        while it < max_iter and not all(bool(g[0]["conv"].all()) for g in groups):
            it += 1
            for entries in groups:
                partials, mism = [], []
                for e in entries:
                    edge_bits, table, mask3 = e["block"]
                    zero = torch.zeros((1, Bl), dtype=dtype, device=e["dev"])
                    if ms_scaling_factor == 0.0 and bp_method == MINIMUM_SUM:
                        alpha = torch.tensor(1.0 - 2.0**-it, dtype=dtype, device=e["dev"])
                    else:
                        alpha = torch.tensor(ms_scaling_factor, dtype=dtype, device=e["dev"])
                    llr_pad = torch.cat([e["llr_post"], zero])
                    v2c3 = llr_pad[edge_bits].reshape(m_loc, dc, Bl) - e["c2v"]
                    if bp_method == MINIMUM_SUM:
                        e["c2v"] = _check_to_bit_min_sum(v2c3, mask3, e["syn"], alpha)
                    else:
                        e["c2v"] = _check_to_bit_product_sum(v2c3, mask3, e["syn"])
                    per_bit = torch.cat([e["c2v"].reshape(-1, Bl), zero])[table]
                    acc = per_bit[:, 0]
                    for k in range(1, per_bit.shape[1]):  # edge order
                        acc = acc + per_bit[:, k]
                    partials.append(acc)
                devs = [e["dev"] for e in entries]
                totals = psum(partials, devs)
                for e, total in zip(entries, totals):
                    llr_new = e["llr_col"] + total
                    hard = llr_new <= 0
                    hard_pad = torch.cat([hard, torch.zeros((1, Bl), dtype=torch.bool,
                                                            device=e["dev"])])
                    cand = hard_pad[e["block"][0]].reshape(m_loc, dc, Bl).sum(dim=1) % 2
                    mism.append((cand != e["syn"]).sum(dim=0))
                    e["llr_new"], e["hard"] = llr_new, hard
                conv_now = [x == 0 for x in psum(mism, devs)]
                for e, now in zip(entries, conv_now):
                    active = ~e["conv"]
                    e["dec"] = torch.where(active[None, :], e["hard"], e["dec"])
                    e["llr_out"] = torch.where(active[None, :], e["llr_new"], e["llr_out"])
                    e["iters"] = torch.where(active, it, e["iters"])
                    e["conv"] = e["conv"] | now
                    e["llr_post"] = e["llr_new"]

        dev0 = grid[0, 0]

        def gather(key, f):
            return torch.cat([f(g[0][key]).to(dev0) for g in groups])[:B0]

        return BpResult(
            decoding=gather("dec", lambda x: x.t().to(torch.uint8)),
            llr_posterior=gather("llr_out", lambda x: x.t()),
            converged=gather("conv", lambda x: x),
            iterations=gather("iters", lambda x: x),
        )

    return decode


class TpBpDecoder:
    """Decoder-class face of :func:`make_tp_bp_decoder`.

    Mirrors :class:`ldpc_tpu_torch.BpDecoder`'s decode/decode_batch surface
    for the common kwargs, with the Tanner graph sharded over the mesh.
    """

    def __init__(
        self,
        pcm,
        mesh,
        *,
        error_rate: Optional[float] = None,
        error_channel=None,
        max_iter: int = 30,
        bp_method: str = "minimum_sum",
        ms_scaling_factor: float = 0.625,
        **mesh_kwargs,
    ):
        pcm = convert_to_binary_sparse(pcm)
        self.graph = compile_pcm(pcm)
        self.m, self.n = self.graph.m, self.graph.n
        if error_channel is None:
            if error_rate is None:
                raise ValueError("error_rate or error_channel required")
            error_channel = np.full(self.n, error_rate)
        self._init_llr = torch.from_numpy(bp_ops.channel_llr(error_channel))
        method = (
            MINIMUM_SUM
            if str(bp_method).lower() in ("ms", "min_sum", "minimum_sum", "1")
            else bp_ops.PRODUCT_SUM
        )
        self._decode = make_tp_bp_decoder(
            self.graph,
            mesh,
            bp_method=method,
            max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor,
            **mesh_kwargs,
        )

    def decode_batch(self, syndromes) -> np.ndarray:
        out = self._decode(np.asarray(syndromes, np.uint8), self._init_llr)
        self.converged = out.converged.cpu().numpy()
        self.iterations = out.iterations.cpu().numpy()
        return out.decoding.cpu().numpy()

    def decode(self, syndrome) -> np.ndarray:
        return self.decode_batch(np.asarray(syndrome)[None, :])[0]
