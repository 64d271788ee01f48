"""Batched localized-statistics decoding (port of ``ldpc_tpu.ops.lsd``).

The whole failed batch decodes at once (arXiv:2406.18655, reference
src_cpp/lsd.hpp):

- Clusters grow around the flipped checks until each is valid
  (:func:`ldpc_tpu_torch.ops.uf.grow_until_valid`, kernel K4' once per
  round). At ``lsd_order == 0`` that masked solve is the per-cluster
  ``lu_solve`` (lsd.hpp:743-760) and its x0 is the decoding.
- At ``lsd_order == w > 0`` every cluster then grows by one bit per round,
  ``w`` rounds, while its nullity (in-cluster non-pivot count) is below
  ``w`` (lsd.hpp:786-810), each round solved by kernel K5', which exports
  the reduced matrix [R | T s]. Every cluster's OSD-w candidates are then
  scored at once: flipping a cluster's non-pivot columns only changes that
  cluster's rows (the masked system is block-diagonal), so the global
  Hamming weight ranks each cluster's candidates, and a per-label minimum
  of integer keys picks every cluster's winner (osd_dense.hpp:106-140;
  ties go to the earlier candidate, as there). The winners compose into
  one solution.

Candidate keys are integers (``weight * STRIDE + enumeration index``), so
the result does not depend on summation order. The sweep works through
the lanes in chunks so that the unpacked R stays small, and gathers R's
columns by index where the JAX package used one-hot contractions.
"""

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops import gf2, gf2_cuda, uf
from ldpc_tpu_torch.ops.osd import pattern_table
from ldpc_tpu_torch.ops.pcm import PcmGraph, graph_to_torch

LSD_0 = 0
LSD_E = 1
LSD_CS = 2

_BIG = 1 << 62  # key of no candidate
# elements of the largest per-chunk sweep tensor, (lanes, candidates, m)
_CHUNK_ELEMENTS = 1 << 28


def make_lsd_decoder(
    graph: PcmGraph,
    lsd_method: int = LSD_0,
    lsd_order: int = 0,
    bits_per_step: int = 1,
    device="cuda",
):
    """Build a batched LSD decoder on ``device``.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) -> (decoding:
    (B, n) uint8, valid: (B,) bool)``. The LLRs are cast to float32, the
    keys the growth and column orders sort (stable: equal keys in column
    order), as the JAX package's decoders call its ``make_lsd_decoder``, so
    a float64 BP posterior is rounded to float32 keys.
    """
    m, n = graph.m, graph.n
    if bits_per_step >= n:
        bits_per_step = 0  # every boundary bit joins: the grow-all rule
    order0 = lsd_order == 0 or lsd_method == LSD_0
    W = lsd_order
    device = resolve_device(device)
    tg = graph_to_torch(graph, device)
    pats_np = pattern_table(lsd_method, W).astype(bool) if not order0 else np.zeros((0, 1), bool)
    pats = torch.from_numpy(pats_np).to(device)
    P = pats_np.shape[0]
    use_singles = not order0 and lsd_method == LSD_CS
    STRIDE = 2 * n + 2
    chunk = max(1, _CHUNK_ELEMENTS // (m * (2 * n + 1 + (m + 1) * max(W, 1))))

    def masked_export(syndromes, llrs, in_bit):
        """K5' on the in-cluster columns, least reliable first."""
        return gf2_cuda.masked_export(tg, syndromes, *uf.cluster_columns(in_bit, llrs))

    def pivot_mask(col_of_row, used):
        ispiv = torch.zeros((used.shape[0], n + 1), dtype=torch.bool, device=device)
        ispiv.scatter_(1, torch.where(used, col_of_row.long(), n), used)
        return ispiv[:, :n]

    def nonpivot_rank(collab, nonpiv_in, llrs):
        """Rank each in-cluster non-pivot column inside its cluster by
        ascending LLR, ties by column (the reference's sort_non_pivot_cols,
        lsd.hpp:823): a stable argsort by LLR, then a stable argsort by
        label. Returns ``(rank (B, n), n off the non-pivots; colof
        (B, m+1, W) int64, the column of each (label, rank < W), n if
        none)``."""
        B = collab.shape[0]
        lab = torch.where(nonpiv_in, collab, uf.INF)
        by_llr = gf2.column_order(llrs)
        perm = by_llr.gather(1, torch.argsort(lab.gather(1, by_llr), dim=1, stable=True))
        lab_sorted = lab.gather(1, perm)
        pos = torch.arange(n, device=device).expand(B, n)
        is_start = torch.ones((B, n), dtype=torch.bool, device=device)
        is_start[:, 1:] = lab_sorted[:, 1:] != lab_sorted[:, :-1]
        seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
        rank_sorted = pos - seg_start
        real = lab_sorted < uf.INF
        rank = torch.empty_like(perm).scatter_(1, perm, torch.where(real, rank_sorted, n))
        put = real & (rank_sorted < W)
        slot = torch.where(put, lab_sorted.clamp(max=m) * W + rank_sorted, (m + 1) * W)
        colof = torch.full((B, (m + 1) * W + 1), n, dtype=torch.int64, device=device)
        colof.scatter_(1, slot, perm)  # the dump slot takes the rest
        return rank, colof[:, :-1].view(B, m + 1, W)

    def sweep(words, col_of_row, used, nonpiv_in, collab, rank, colof):
        """The per-cluster OSD-w winners of one chunk of lanes, composed."""
        B = words.shape[0]
        lanes = torch.arange(B, device=device)[:, None]
        bits = gf2.unpack_u32(words, n + 1).bool()  # (B, m, n+1)
        s = bits[:, :, n]
        Rt = torch.cat(  # R's columns, and a zero column n for pad slots
            [bits[:, :, :n].transpose(1, 2),
             torch.zeros((B, 1, m), dtype=torch.bool, device=device)], dim=1
        )
        base = (s & used).sum(dim=1)  # the baseline's weight
        key_pat = torch.full((B, m + 1), _BIG, dtype=torch.int64, device=device)
        win_p = torch.zeros((B, m + 1), dtype=torch.int64, device=device)
        slot_ok = colof < n
        if P:
            Rcol = Rt[lanes, colof.reshape(B, -1)].view(B, m + 1, W, m)
            for p in range(P):
                y = s[:, None, :].expand(B, m + 1, m)
                okp = torch.ones((B, m + 1), dtype=torch.bool, device=device)
                for w in np.flatnonzero(pats_np[p]):
                    y = y ^ Rcol[:, :, w, :]
                    okp = okp & slot_ok[:, :, w]
                sc = (y & used[:, None, :]).sum(dim=2) + int(pats_np[p].sum())
                key = torch.where(okp, sc * STRIDE + 1 + n + p, _BIG)
                win_p = torch.where(key < key_pat, p, win_p)
                key_pat = torch.minimum(key_pat, key)
        best = key_pat
        if use_singles:
            sc_s = ((s[:, None, :] ^ Rt[:, :n, :]) & used[:, None, :]).sum(dim=2) + 1
            key_s = torch.where(nonpiv_in, sc_s * STRIDE + 1 + rank.clamp(max=n), _BIG)
            labc = torch.where(nonpiv_in, collab.clamp(max=m), m + 1)
            key_sing = torch.full((B, m + 2), _BIG, dtype=torch.int64, device=device)
            key_sing.scatter_reduce_(1, labc, key_s, "amin")
            # keys are unique inside a cluster: one column attains each
            hit = nonpiv_in & (key_s == key_sing.gather(1, labc))
            arg_sing = torch.full((B, m + 2), n, dtype=torch.int64, device=device)
            cols = torch.arange(n, device=device).expand(B, n)
            arg_sing.scatter_reduce_(1, labc, torch.where(hit, cols, n), "amin")
            key_sing, arg_sing = key_sing[:, : m + 1], arg_sing[:, : m + 1]
            best = torch.minimum(best, key_sing)
        improved = best < base[:, None] * STRIDE  # (B, m+1)
        pat_won = improved & (best == key_pat)

        # compose: y* = T s ^ R's winning columns (distinct across clusters)
        flip = torch.zeros((B, n + 1), dtype=torch.bool, device=device)
        if P:
            use_slot = pats[win_p] & slot_ok & pat_won[:, :, None]  # (B, m+1, W)
            flip.scatter_(1, torch.where(use_slot, colof, n).reshape(B, -1), True)
        if use_singles:
            sing_won = improved & ~pat_won
            flip.scatter_(1, torch.where(sing_won, arg_sing, n), True)
        flip = flip[:, :n]
        parity = (Rt[:, :n, :] & flip[:, :, None]).sum(dim=1) % 2
        ystar = s ^ (parity == 1)
        x = torch.zeros((B, n + 1), dtype=torch.uint8, device=device)
        x.scatter_(1, torch.where(used, col_of_row.long(), n), (ystar & used).to(torch.uint8))
        return x[:, :n] | flip.to(torch.uint8)

    def decode(syndromes: torch.Tensor, llrs: torch.Tensor):
        syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device).contiguous()
        llrs = torch.as_tensor(llrs, dtype=torch.float32, device=device)
        in_bit, x0, valid = uf.grow_until_valid(tg, syndromes, llrs, bits_per_step)
        if order0:
            return x0, valid

        seed = syndromes == 1
        words, col_of_row, used = masked_export(syndromes, llrs, in_bit)
        labels, _ = uf.propagate_labels(tg, in_bit, seed)
        rank = uf.llr_rank(llrs)
        # grow every cluster whose nullity is below W by one bit per round
        for _ in range(W):
            labels, _ = uf.propagate_labels(tg, in_bit, seed, warm=labels)
            collab = uf.bit_labels(tg, labels, in_bit)
            nonpiv_in = in_bit & ~pivot_mask(col_of_row, used)
            nullity = torch.zeros((in_bit.shape[0], m + 2), dtype=torch.int64, device=device)
            nullity.scatter_add_(
                1, torch.where(nonpiv_in, collab.clamp(max=m), m + 1), nonpiv_in.long()
            )
            live = labels < uf.INF
            nul_of_chk = nullity.gather(1, torch.where(live, labels.clamp(max=m), m + 1))
            in_bit, _ = uf.grow_round(tg, in_bit, (nul_of_chk < W) & live, rank, 1)
            words, col_of_row, used = masked_export(syndromes, llrs, in_bit)

        s = ((words[:, :, n // 32] >> (n % 32)) & 1).bool()
        valid = ~(s & ~used).any(dim=1)
        labels, _ = uf.propagate_labels(tg, in_bit, seed, warm=labels)
        collab = uf.bit_labels(tg, labels, in_bit)
        nonpiv_in = in_bit & ~pivot_mask(col_of_row, used)
        rank_np, colof = nonpivot_rank(collab, nonpiv_in, llrs)
        per_lane = (words, col_of_row, used, nonpiv_in, collab, rank_np, colof)
        parts = [
            sweep(*(t[i : i + chunk] for t in per_lane))
            for i in range(0, syndromes.shape[0], chunk)
        ]
        if not parts:
            return torch.zeros((0, n), dtype=torch.uint8, device=device), valid
        return torch.cat(parts), valid

    return decode
