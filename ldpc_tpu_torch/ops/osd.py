"""Batched ordered-statistics decoding (port of ``ldpc_tpu.ops.osd``).

Every lane takes its columns least-reliable-first (a stable argsort of the
BP posterior LLRs) and solves H x = s by Gauss-Jordan elimination in that
order (:mod:`ldpc_tpu_torch.ops.gf2_cuda`).

- Order 0 runs kernel K2' with its syndrome fast exit.
- Higher orders (OSD-E, OSD-CS) run kernel K3' to rank, which exports the
  reduced matrix [R | T s], and sweep the candidates as
  ``make_osd_sweep_tpu`` does: a candidate flips a set of non-pivot columns
  and its solution reads off as ``y = T s ^ XOR of R's flipped columns``,
  scored by the weights ``log(1/p)`` of its support. OSD-CS scores every
  single non-pivot column and the pairs inside the ``order`` least reliable
  non-pivots; OSD-E scores every pattern over those. The first minimum in
  the reference's enumeration order (baseline, singles by reliability,
  patterns) wins (osd.hpp:163-180).

The sweep gathers R's columns by index instead of the JAX package's one-hot
contractions, works through the lanes in chunks so that the unpacked R
stays small, and sums each score over the rows in row order with one
addition per row in the decoder's dtype (float32, or float64 after the
fold-exact BP): the same additions on every device, so a tie is broken the
same way on the CPU and on the card.
"""

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops import gf2, gf2_cuda
from ldpc_tpu_torch.ops.pcm import PcmGraph, graph_to_torch
from ldpc_tpu_torch.utils.profiling import count, span

OSD_OFF = -1
OSD_0 = 0
EXHAUSTIVE = 1
COMBINATION_SWEEP = 2

# elements of the largest per-chunk sweep tensor, (lanes, candidates, m):
# the d=13 OSD-CS bucket (about 6,000 lanes) fits in one chunk
_CHUNK_ELEMENTS = 1 << 28


def candidate_strings(osd_method: int, osd_order: int, k: int) -> np.ndarray:
    """The (C, k) candidate block, row 0 = all-zero (the OSD-0 baseline).

    EXHAUSTIVE enumerates 1..2^order-1 LSB-first (reference: osd.hpp:75-80);
    COMBINATION_SWEEP takes every weight-1 pattern plus all weight-2
    patterns inside the first ``osd_order`` positions (osd.hpp:82-101).
    """
    order = min(osd_order, k)  # the reference indexes out of bounds past k
    cands = [np.zeros(k, dtype=np.uint8)]
    if osd_method == EXHAUSTIVE:
        for i in range(1, 2**order):
            cands.append(np.array([(i >> j) & 1 for j in range(k)], dtype=np.uint8))
    elif osd_method == COMBINATION_SWEEP:
        for i in range(k):
            c = np.zeros(k, dtype=np.uint8)
            c[i] = 1
            cands.append(c)
        for i in range(order):
            for j in range(i + 1, order):
                c = np.zeros(k, dtype=np.uint8)
                c[i] = 1
                c[j] = 1
                cands.append(c)
    return np.stack(cands) if k else np.zeros((1, 0), np.uint8)


def pattern_table(method: int, order: int) -> np.ndarray:
    """The slot-limited candidates over the ``order`` least reliable
    non-pivot slots, in the reference's enumeration order: EXHAUSTIVE ->
    every nonzero pattern; COMBINATION_SWEEP -> the weight-2 pairs (its
    singles run over every non-pivot column and are swept separately).
    (P, order) uint8."""
    pats = candidate_strings(method, order, order)[1:]  # no baseline
    if method == COMBINATION_SWEEP:
        pats = pats[order:]
    return pats if len(pats) else np.zeros((0, max(order, 1)), np.uint8)


def weigh_rows(y: torch.Tensor, wrow: torch.Tensor) -> torch.Tensor:
    """Weight of each candidate's pivot part: (B, C, m) bool solution bits,
    (B, m) row weights -> (B, C) in their dtype, summed in row order."""
    terms = torch.where(y, wrow[:, None, :], 0.0)
    acc = terms[:, :, 0].clone()
    for r in range(1, y.shape[2]):
        acc += terms[:, :, r]
    return acc


def _first_min(score: torch.Tensor):
    """Per-row minimum and the first index that attains it."""
    low = score.min(dim=1).values
    idx = torch.arange(score.shape[1], device=score.device)
    first = torch.where(score == low[:, None], idx, score.shape[1]).min(dim=1).values
    return low, first


def make_osd_decoder(
    graph: PcmGraph,
    channel: np.ndarray,
    osd_method: int,
    osd_order: int,
    device,
    dtype=torch.float32,
):
    """Build a batched OSD decoder on ``device``.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) -> (osd0: (B, n)
    uint8, osdw: (B, n) uint8, valid: (B,) bool)``; at order 0 the two
    decodings are the same tensor. The reliability order and the candidate
    weights are taken in ``dtype`` (float32 or float64, the BP engine's).
    ``channel`` only weighs the candidates of higher orders. With the
    recorder on (:mod:`ldpc_tpu_torch.utils.profiling`) a call is the span
    ``osd`` over ``osd.order``, ``osd.elim`` (K2' or K3') and an
    ``osd.sweep`` a chunk of lanes, and counts ``lanes.osd`` and
    ``osd.chunks``.
    """
    m, n = graph.m, graph.n
    rank = gf2.batched_rank(graph.dense)
    k = n - rank
    order0 = osd_method in (OSD_0, OSD_OFF) or osd_order == 0 or k == 0
    device = resolve_device(device)
    tg = graph_to_torch(graph, device)
    W = min(osd_order, k)
    use_singles = osd_method == COMBINATION_SWEEP
    pats = torch.from_numpy(pattern_table(osd_method, W).astype(bool)).to(device)
    P = pats.shape[0]
    with np.errstate(divide="ignore"):
        w_np = np.log(1.0 / np.asarray(channel, dtype=np.float64))
    # pad column n (the rows no pivot owns) weighs nothing
    weights_pad = torch.from_numpy(np.concatenate([w_np, [0.0]])).to(
        device=device, dtype=dtype
    )
    chunk = max(1, _CHUNK_ELEMENTS // (m * (n + P + 1)))

    def sweep(words, col_of_row, used, llrs):
        """OSD-0 and OSD-w of one chunk of lanes from K3's export."""
        B = words.shape[0]
        lanes = torch.arange(B, device=device)[:, None]
        bits = gf2.unpack_u32(words, n + 1).bool()  # (B, m, n+1)
        s = bits[:, :, n]
        Rt = bits[:, :, :n].transpose(1, 2)  # (B, n, m): R's columns
        target = torch.where(used, col_of_row.long(), n)
        osd0 = torch.zeros((B, n + 1), dtype=torch.uint8, device=device)
        osd0.scatter_(1, target, (s & used).to(torch.uint8))
        ispiv = torch.zeros((B, n + 1), dtype=torch.bool, device=device)
        ispiv.scatter_(1, target, used)
        wrow = weights_pad[target]  # (B, m); unused rows weigh 0

        best = weigh_rows(s[:, None, :], wrow)[:, 0]  # the baseline
        kind = torch.zeros(B, dtype=torch.int64, device=device)  # 0 base, 1 single, 2 pattern
        # non-pivot columns, least reliable first (ties: column order)
        npkey = torch.where(ispiv[:, :n], torch.inf, llrs)
        np_cols = torch.argsort(npkey, dim=1, stable=True)[:, :k]  # (B, k)
        R_np = Rt[lanes, np_cols]  # (B, k, m)
        single = torch.zeros(B, dtype=torch.int64, device=device)
        if use_singles:
            score1 = weigh_rows(s[:, None, :] ^ R_np, wrow) + weights_pad[np_cols]
            min1, j1 = _first_min(score1)
            take1 = min1 < best
            best = torch.where(take1, min1, best)
            kind = torch.where(take1, 1, kind)
            single = np_cols.gather(1, j1[:, None]).squeeze(1)
        p_star = torch.zeros(B, dtype=torch.int64, device=device)
        if P:
            Y = s[:, None, :].expand(B, P, m).clone()
            for w in range(W):
                Y ^= pats[None, :, w, None] & R_np[:, w, None, :]
            wt_W = weights_pad[np_cols[:, :W]]  # (B, W)
            score_p = weigh_rows(Y, wrow)
            for w in range(W):
                score_p = score_p + torch.where(pats[None, :, w], wt_W[:, w, None], 0.0)
            minp, p_star = _first_min(score_p)
            takep = minp < best
            kind = torch.where(takep, 2, kind)

        # the winner: y = T s ^ R's flipped columns; flipped columns are 1
        y = s.clone()
        flip = torch.zeros((B, n + 1), dtype=torch.bool, device=device)
        is1 = kind == 1
        y ^= is1[:, None] & Rt[lanes[:, 0], single]
        flip.scatter_(1, torch.where(is1, single, n)[:, None], True)
        if P:
            won = pats[p_star] & (kind == 2)[:, None]  # (B, W)
            for w in range(W):
                y ^= won[:, w, None] & R_np[:, w, :]
                flip.scatter_(1, torch.where(won[:, w], np_cols[:, w], n)[:, None], True)
        osdw = torch.zeros((B, n + 1), dtype=torch.uint8, device=device)
        osdw.scatter_(1, target, (y & used).to(torch.uint8))
        osdw = osdw[:, :n] | flip[:, :n].to(torch.uint8)
        return osd0[:, :n], osdw

    def decode(syndromes: torch.Tensor, llrs: torch.Tensor):
        count("lanes.osd", syndromes.shape[0])
        with span("osd", lanes=syndromes.shape[0]):
            return _decode(syndromes, llrs)

    def _decode(syndromes: torch.Tensor, llrs: torch.Tensor):
        syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device)
        llrs = torch.as_tensor(llrs, device=device).to(dtype)
        # least-reliable-first; stable, as the reference's qsort is on
        # distinct keys
        with span("osd.order"):
            order = gf2.column_order(llrs).to(torch.int32)
        if order0:
            with span("osd.elim"):
                x0, valid = gf2_cuda.osd0(
                    tg, syndromes.contiguous(), order.contiguous(), rank
                )
            return x0, x0, valid
        with span("osd.elim"):
            words, col_of_row, used = gf2_cuda.rref_export(
                tg, syndromes.contiguous(), order.contiguous(), rank
            )
        s = ((words[:, :, n // 32] >> (n % 32)) & 1).bool()
        valid = ~(s & ~used).any(dim=1)
        parts = []
        for c, i in enumerate(range(0, syndromes.shape[0], chunk)):
            lanes = min(chunk, syndromes.shape[0] - i)
            count("osd.chunks")
            with span("osd.sweep", lanes=lanes, chunk=c):
                parts.append(sweep(words[i : i + chunk], col_of_row[i : i + chunk],
                                   used[i : i + chunk], llrs[i : i + chunk]))
        if not parts:
            empty = torch.zeros((0, n), dtype=torch.uint8, device=device)
            return empty, empty, valid
        return (
            torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            valid,
        )

    return decode
