"""Cluster growth and the union-find decoders (port of ``ldpc_tpu.ops.uf``).

A cluster is a connected component of the Tanner subgraph spanned by the
in-cluster bits (``in_bit``, (B, n) bool) and the checks they touch, plus
the flipped syndrome checks. The growth loop of LSD and of the union-find
decoders repeats one round until every cluster is valid, i.e. its syndrome
lies in the image of its columns:

1. kernel K4' (:func:`ldpc_tpu_torch.ops.gf2_cuda.masked_solve`) eliminates
   each lane's in-cluster columns, least reliable first; an unused row that
   still holds a syndrome 1 marks its cluster invalid (the masked system is
   block-diagonal over clusters);
2. :func:`grow_round` lets every invalid cluster admit its
   ``bits_per_step`` lowest-LLR boundary bits (every boundary bit when
   ``bits_per_step`` is 0), with the join rule of ``_grow_round_mm``.

Graph sweeps are index gathers on the ELL arrays (``chk_bits``,
``var_chks``); keys and labels are int64, so no float bound on the code
size applies. Fixpoint loops (label propagation, floodfills) test for
convergence every ``_SWEEPS`` sweeps, since each test is a host sync and
extra sweeps at a fixpoint change nothing. The recorder counts those syncs
under ``sync.uf_any`` and the growth rounds' under ``sync.uf_growth``.

:func:`make_uf_decoder` (inversion mode) reads its decoding from the last
round's K4' solve; :func:`make_peel_decoder` (peeling mode) solves the grown
clusters once more in the JAX package's ``forest_solve`` column order. The
JAX package's staged growth (``grow_staged_fast``, ``grow_staged_multi``)
has no counterpart: :func:`grow_until_valid` already runs each round on the
lanes still invalid only, which is what staging does on the TPU, with the
same result lane for lane.
"""

from typing import Optional, Tuple

import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops import gf2, gf2_cuda
from ldpc_tpu_torch.ops.pcm import PcmGraph, TorchGraph, graph_to_torch
from ldpc_tpu_torch.utils.profiling import sync

INF = 2**30  # no label / no key: above every check index and LLR rank
_SWEEPS = 4  # graph sweeps between two convergence tests


def _any(x: torch.Tensor) -> bool:
    """``x.any()`` on the host: one sync, counted (``sync.uf_any``)."""
    with sync("uf_any"):
        return bool(x.any())


def _pad(x: torch.Tensor, fill) -> torch.Tensor:
    """Append one column of ``fill``: the target of the ELL pad slots."""
    return torch.cat([x, torch.full_like(x[:, :1], fill)], dim=1)


def chk_to_bit_min(tg: TorchGraph, x_chk: torch.Tensor, fill) -> torch.Tensor:
    """Each bit's minimum of ``x_chk`` (B, m) over its checks: (B, n)."""
    return _pad(x_chk, fill)[:, tg.var_chks.long()].min(dim=2).values


def bit_to_chk_min(tg: TorchGraph, x_bit: torch.Tensor, fill) -> torch.Tensor:
    """Each check's minimum of ``x_bit`` (B, n) over its bits: (B, m)."""
    return _pad(x_bit, fill)[:, tg.chk_bits.long()].min(dim=2).values


def flood(tg: TorchGraph, x0: torch.Tensor, in_bit: torch.Tensor) -> torch.Tensor:
    """Min-floodfill of per-check values (B, m) through in-cluster bits:
    every check ends with the minimum over its cluster."""
    x = x0
    while True:
        before = x
        for _ in range(_SWEEPS):
            bl = torch.where(in_bit, chk_to_bit_min(tg, x, INF), INF)
            x = torch.minimum(x, bit_to_chk_min(tg, bl, INF))
        if not _any(x != before):
            return x


def propagate_labels(
    tg: TorchGraph,
    in_bit: torch.Tensor,
    seed_checks: torch.Tensor,
    warm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-label propagation over the active Tanner subgraph
    (``_propagate_labels``).

    Active checks are the seeds and the checks adjacent to in-cluster bits;
    a cluster's label is its smallest check index. ``warm`` starts from an
    earlier round's labels, which bound the fixpoint from above (labels only
    fall as clusters grow and merge). Returns ``(labels (B, m) int64, INF
    outside clusters; active_chk (B, m) bool)``.
    """
    m = tg.m
    touched = _pad(in_bit, False)[:, tg.chk_bits.long()].any(dim=2)
    active_chk = seed_checks | touched
    iota = torch.arange(m, device=in_bit.device)[None, :]
    lab0 = torch.where(active_chk, iota, INF)
    if warm is not None:
        lab0 = torch.where(active_chk, torch.minimum(lab0, warm), INF)
    return flood(tg, lab0, in_bit), active_chk


def bit_labels(tg: TorchGraph, labels: torch.Tensor, in_bit: torch.Tensor) -> torch.Tensor:
    """The cluster label of each in-cluster bit (INF elsewhere): (B, n)."""
    return torch.where(in_bit, chk_to_bit_min(tg, labels, INF), INF)


def invalid_checks_from_bad(
    bad_row: torch.Tensor, labels: torch.Tensor, m: int
) -> torch.Tensor:
    """Per-check invalid-cluster flags from the per-row "unused with
    syndrome 1" flags: a cluster is invalid iff one of its rows is flagged."""
    lab_clip = labels.clamp(max=m)
    invalid = torch.zeros((labels.shape[0], m + 1), dtype=torch.int64, device=labels.device)
    invalid.scatter_reduce_(1, lab_clip, bad_row.long(), "amax")
    return (invalid.gather(1, lab_clip) > 0) & (labels < INF)


def llr_rank(llrs: torch.Tensor) -> torch.Tensor:
    """Each bit's position in its lane's stable ascending LLR order (int64,
    NaN last: :func:`ldpc_tpu_torch.ops.gf2.column_order`)."""
    sub = gf2.column_order(llrs)
    rank = torch.empty_like(sub)
    iota = torch.arange(llrs.shape[1], device=llrs.device).expand_as(sub)
    return rank.scatter_(1, sub, iota)


def cluster_columns(
    in_bit: torch.Tensor, key: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K4'/K5' column order of each lane's in-cluster bits, ascending
    ``key`` (stable), and their count: ``(order (B, n) int32, count (B,)
    int32)``."""
    masked = torch.where(in_bit, key, torch.inf)
    order = gf2.column_order(masked).to(torch.int32).contiguous()
    return order, in_bit.sum(dim=1).to(torch.int32)


def grow_round(
    tg: TorchGraph,
    in_bit: torch.Tensor,
    bad_row: torch.Tensor,
    rank: torch.Tensor,
    bits_per_step: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One growth round (``_grow_round_mm``): every cluster holding a
    flagged row admits its ``bits_per_step`` boundary bits of lowest
    ``rank``, one per sub-round; ``bits_per_step == 0`` admits every bit
    adjacent to an invalid check.

    A bit joins when it is not yet in a cluster and its rank is the
    minimum candidate key of an adjacent invalid cluster; a bit adjacent
    to several invalid clusters competes in each. Returns ``(new_in,
    any_invalid (B,) bool)``.
    """
    B = in_bit.shape[0]
    badmin0 = torch.where(bad_row, 0, INF)
    if bits_per_step == 0:
        invalid = flood(tg, badmin0, in_bit) == 0
        nbr = _pad(invalid, False)[:, tg.var_chks.long()].any(dim=2)
        return in_bit | nbr, invalid.any(dim=1)
    grown = in_bit
    invalid = None
    for _ in range(bits_per_step):
        keymin0 = bit_to_chk_min(tg, torch.where(grown, INF, rank), INF)
        if invalid is None:
            # one floodfill for both: the stacked rows are independent
            both = flood(tg, torch.cat([badmin0, keymin0]), torch.cat([in_bit, in_bit]))
            invalid, keymin = both[:B] == 0, both[B:]
        else:
            keymin = flood(tg, keymin0, in_bit)
        cluster_min = _pad(torch.where(invalid, keymin, INF), INF)[:, tg.var_chks.long()]
        grown = grown | ((cluster_min == rank[:, :, None]).any(dim=2) & ~grown)
    return grown, invalid.any(dim=1)


def grow_until_valid(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    llrs: torch.Tensor,
    bits_per_step: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The growth loop with ``grow_until_valid_fast``'s semantics: K4' once
    per round, then :func:`grow_round`, at most n+1 rounds.

    A lane whose clusters are all valid keeps its state (the JAX loop
    re-solves it unchanged), so each round runs on the lanes still invalid
    only. Returns ``(in_bit (B, n) bool, x0 (B, n) uint8 in original
    coordinates, valid (B,) bool)``.
    """
    B, n = llrs.shape
    dev = llrs.device
    rank = llr_rank(llrs)
    in_bit = torch.zeros((B, n), dtype=torch.bool, device=dev)
    x0 = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    bad = torch.zeros((B, tg.m), dtype=torch.bool, device=dev)
    idx = torch.arange(B, device=dev)
    for _ in range(n + 1):
        if not idx.numel():
            break
        lane_in = in_bit[idx]
        order, count = cluster_columns(lane_in, llrs[idx])
        x, bad_row = gf2_cuda.masked_solve(tg, syndromes[idx].contiguous(), order, count)
        new_in, any_invalid = grow_round(tg, lane_in, bad_row, rank[idx], bits_per_step)
        x0[idx] = x
        bad[idx] = bad_row
        in_bit[idx] = torch.where(any_invalid[:, None], new_in, lane_in)
        with sync("uf_growth"):
            idx = idx[any_invalid]
    return in_bit, x0, ~bad.any(dim=1)


def _decoder_inputs(syndromes, llrs, device):
    syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device).contiguous()
    llrs = torch.as_tensor(llrs, dtype=torch.float32, device=device)
    return syndromes, llrs


def make_uf_decoder(graph: PcmGraph, bits_per_step: int = 0, device="cuda"):
    """Batched union-find decoder, inversion mode (``make_uf_decoder``;
    reference union_find.hpp:485-532): grow until valid, K4' once per
    round; the last round's solve is the decoding.

    ``bits_per_step == 0`` grows every boundary bit of every invalid cluster
    per round; otherwise each invalid cluster admits its ``bits_per_step``
    lowest-LLR boundary bits per round (BeliefFind). ``bits_per_step >= n``
    admits every boundary bit, the same as 0.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) -> (decoding:
    (B, n) uint8, valid: (B,) bool)``; the LLRs are cast to float32, the
    keys the growth sorts, as in the JAX package, so a float64 BP posterior
    is rounded to float32 keys.
    """
    if bits_per_step >= graph.n:
        bits_per_step = 0
    device = resolve_device(device)
    tg = graph_to_torch(graph, device)

    def decode(syndromes: torch.Tensor, llrs: torch.Tensor):
        syndromes, llrs = _decoder_inputs(syndromes, llrs, device)
        _, x0, valid = grow_until_valid(tg, syndromes, llrs, bits_per_step)
        return x0, valid

    return decode


def make_peel_decoder(graph: PcmGraph, bits_per_step: int = 0, device="cuda"):
    """Batched union-find decoder, peeling mode (``make_peel_decoder``;
    reference union_find.hpp:428-480), for column degree <= 2.

    Growth is the inversion decoder's: for column degree <= 2 a cluster's
    syndrome lies in the image of its columns exactly when its parity is
    even or it holds a degree-1 (boundary) column, the peeling validity
    rule. The grown clusters are then solved by one more K4' elimination
    over their columns in the order [interior ascending, boundary
    ascending] (``forest_solve``): its greedy pivots are a spanning forest
    of each cluster plus at most one boundary edge, and its solution is that
    forest's tree solution, which peeling computes. Valid means no unused
    row still holds a syndrome 1.

    Returns ``decode(syndromes, llrs) -> (decoding (B, n) uint8, valid (B,)
    bool)``; the LLRs are cast to float32 as in :func:`make_uf_decoder`.
    """
    if graph.dv > 2:
        raise ValueError("peeling requires column degree <= 2")
    if bits_per_step >= graph.n:
        bits_per_step = 0
    n = graph.n
    device = resolve_device(device)
    tg = graph_to_torch(graph, device)
    if graph.dv == 2:
        interior = tg.var_mask[:, 1]  # two real endpoints
    else:
        interior = torch.zeros(n, dtype=torch.bool, device=device)
    # interior columns first, boundary columns after, each ascending
    col_key = (torch.arange(n, device=device) + torch.where(interior, 0, n)).float()

    def decode(syndromes: torch.Tensor, llrs: torch.Tensor):
        syndromes, llrs = _decoder_inputs(syndromes, llrs, device)
        in_bit, _, _ = grow_until_valid(tg, syndromes, llrs, bits_per_step)
        order, count = cluster_columns(in_bit, col_key.expand_as(llrs))
        x0, bad_row = gf2_cuda.masked_solve(tg, syndromes, order, count)
        return x0, ~bad_row.any(dim=1)

    return decode
