"""Plain PyTorch min-sum belief propagation, parallel schedule.

The recurrence the configurations state (min-sum with scaling factor
alpha, at most ``max_iter`` iterations, each lane stopping at its first
iteration whose hard decision reproduces its syndrome), written as plain
tensor operations in the order that fixes its float rounding:

- bit to check: the bit's posterior minus the check's last message to it
  (zero before the first iteration);
- check to bit: ``(alpha * sign) * min`` over the check's other bits, the
  sign counting a message <= 0 as negative and the syndrome bit as one more
  negative;
- posterior: the channel LLR plus the sum of the bit's incoming messages,
  summed in the order of the checks' indices; hard decision ``posterior <= 0``.

``dtype`` is float32 for the reference and bfloat16 for the control. The
lanes run in chunks, and the lanes still running are compacted every
iteration: each lane's arithmetic is its own, so neither changes a result.
"""

from typing import NamedTuple

import numpy as np
import torch

_BIG = 1e30  # magnitude standing in for an absent slot in the minimum
_CHUNK_ELEMENTS = 1 << 25  # (lanes x checks x row slots) of one chunk


class Graph(NamedTuple):
    """A dense 0/1 check matrix as padded index tables on one device."""

    m: int
    n: int
    dc: int
    dv: int
    chk_bits: torch.Tensor  # (m, dc) long, the check's bits ascending, pad = n
    chk_mask: torch.Tensor  # (m, dc) bool
    var_edges: torch.Tensor  # (n, dv) long, flat edge i * dc + slot, pad = m * dc
    dense: torch.Tensor  # (m, n) uint8


def graph(H: np.ndarray, device) -> Graph:
    H = np.asarray(H, np.uint8) % 2
    m, n = H.shape
    rows = [np.flatnonzero(H[i]) for i in range(m)]
    dc = max(len(r) for r in rows)
    chk_bits = np.full((m, dc), n, np.int64)
    chk_mask = np.zeros((m, dc), bool)
    var_lists = [[] for _ in range(n)]
    for i, r in enumerate(rows):
        chk_bits[i, : len(r)] = r
        chk_mask[i, : len(r)] = True
        for slot, j in enumerate(r):
            var_lists[j].append(i * dc + slot)
    dv = max(1, max(len(v) for v in var_lists))
    var_edges = np.full((n, dv), m * dc, np.int64)
    for j, v in enumerate(var_lists):
        var_edges[j, : len(v)] = v
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Graph(m, n, dc, dv, t(chk_bits), t(chk_mask), t(var_edges), t(H))


class BpOut(NamedTuple):
    decoding: torch.Tensor  # (B, n) uint8
    posterior: torch.Tensor  # (B, n) in the run's dtype
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int64


def min_sum(g: Graph, syndromes: torch.Tensor, llr0: torch.Tensor, alpha: float,
            max_iter: int, dtype=torch.float32) -> BpOut:
    """Min-sum BP of (B, m) uint8 syndromes with the (n,) channel LLRs
    ``llr0``."""
    B = syndromes.shape[0]
    dev = syndromes.device
    out = BpOut(
        torch.zeros((B, g.n), dtype=torch.uint8, device=dev),
        torch.zeros((B, g.n), dtype=dtype, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev),
    )
    chunk = max(1, _CHUNK_ELEMENTS // (g.m * g.dc))
    for a in range(0, B, chunk):
        _run(g, syndromes[a : a + chunk], llr0, alpha, max_iter, dtype, out, a)
    return out


def _run(g, syn, llr0, alpha, max_iter, dtype, out, offset):
    dev = syn.device
    m, n, dc = g.m, g.n, g.dc
    llr = llr0.to(device=dev, dtype=torch.float32).to(dtype)
    alpha_t = torch.tensor(alpha, dtype=dtype, device=dev)
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    slot = torch.arange(dc, device=dev)[None, None, :]
    mask = g.chk_mask[None]
    s = syn.to(torch.int64)
    lanes = torch.arange(syn.shape[0], device=dev) + offset  # rows of `out` still running
    post = llr.expand(syn.shape[0], n)
    c2v = torch.zeros((syn.shape[0], m, dc), dtype=dtype, device=dev)
    for it in range(1, max_iter + 1):
        a = lanes.shape[0]
        if a == 0:
            break
        zero = torch.zeros((a, 1), dtype=dtype, device=dev)
        v2c = torch.cat([post, zero], 1)[:, g.chk_bits] - c2v
        absv = torch.where(mask, v2c.abs(), big)
        neg = (mask & (v2c <= 0)).to(torch.int64)
        min1, amin = absv.min(dim=2)
        is_min = slot == amin[:, :, None]
        min2 = torch.where(is_min, big, absv).min(dim=2).values
        parity = (s[:, :, None] + neg.sum(dim=2, keepdim=True) + neg) % 2
        excl = torch.where(is_min, min2[:, :, None], min1[:, :, None])
        sign = (1 - 2 * parity).to(dtype)
        c2v = torch.where(mask, alpha_t * sign * excl, torch.zeros((), dtype=dtype, device=dev))
        per_bit = torch.cat([c2v.reshape(a, m * dc), zero], 1)[:, g.var_edges]
        acc = per_bit[:, :, 0]
        for k in range(1, g.dv):
            acc = acc + per_bit[:, :, k]
        post = llr + acc
        hard = post <= 0
        hard_pad = torch.cat([hard, torch.zeros((a, 1), dtype=torch.bool, device=dev)], 1)
        synd = hard_pad[:, g.chk_bits].to(torch.int64).sum(dim=2) % 2
        done = (synd == s).all(dim=1) | (it == max_iter)
        idx = lanes[done]
        out.decoding[idx] = hard[done].to(torch.uint8)
        out.posterior[idx] = post[done]
        out.converged[idx] = (synd == s).all(dim=1)[done]
        out.iterations[idx] = it
        keep = ~done
        lanes, post, c2v, s = lanes[keep], post[keep], c2v[keep], s[keep]
