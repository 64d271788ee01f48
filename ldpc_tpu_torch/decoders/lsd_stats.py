"""LSD decode statistics: per-cluster growth history (port of
``ldpc_tpu.decoders.lsd_stats``).

The reference records per-cluster growth steps, merges, size history and
a timestep -> (cluster -> added bits) map while decoding (reference:
src_cpp/lsd.hpp:464-603,652-816 and
src_python/ldpc/bplsd_decoder/_bplsd_decoder.pyx:174-321). The batched
decoder does not emit ragged per-cluster records, so statistics mode
replays the growth loop for the one syndrome it describes with the port's
own primitives (:func:`~ldpc_tpu_torch.ops.uf.propagate_labels`, kernel K4'
through :func:`~ldpc_tpu_torch.ops.gf2_cuda.masked_solve`,
:func:`~ldpc_tpu_torch.ops.uf.invalid_checks_from_bad`,
:func:`~ldpc_tpu_torch.ops.uf.grow_round`), so the clusters of every
timestep are the decoder's, and derives the statistics on the host, one
pull per timestep.

Cluster ids: the reference ids clusters by creation order and keeps the
larger cluster on merge (lsd.hpp:190-293); min-label propagation keeps the
lowest seed check index, as the JAX package does. Cluster contents per
timestep are the reference's; only which id survives a merge differs.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ldpc_tpu_torch.decoders.lsd_common import ClusterStatistics, Statistics
from ldpc_tpu_torch.ops import gf2_cuda
from ldpc_tpu_torch.ops import uf
from ldpc_tpu_torch.ops.pcm import TorchGraph


def _stat_round(tg: TorchGraph, in_bit, syndrome, llr, rank, seed, bits_per_step):
    """One growth timestep on one lane: ``(labels, chk_invalid, new_in,
    joined)``, ``joined`` being the cluster each bit would join, the minimum
    label over its adjacent invalid checks (the rule the growth selects
    by)."""
    labels, _ = uf.propagate_labels(tg, in_bit, seed)
    _, bad_row = gf2_cuda.masked_solve(tg, syndrome, *uf.cluster_columns(in_bit, llr))
    chk_invalid = uf.invalid_checks_from_bad(bad_row, labels, tg.m)
    new_in, _ = uf.grow_round(tg, in_bit, bad_row, rank, bits_per_step)
    joined = uf.chk_to_bit_min(tg, torch.where(chk_invalid, labels, uf.INF), uf.INF)
    return labels, chk_invalid, new_in, joined


def _host(*tensors):
    return tuple(t[0].cpu().numpy() for t in tensors)


def compute_lsd_statistics(
    tg: TorchGraph,
    dense: np.ndarray,
    syndrome: np.ndarray,
    llrs: np.ndarray,
    bits_per_step: int,
    decoding: np.ndarray,
    stats: Optional[Statistics] = None,
) -> Statistics:
    """Replay the grow-until-valid loop for one syndrome on ``tg``'s device
    and fill the reference's statistics schema (lsd.hpp:683-784 timestep
    semantics: one timestep is one round that grows every invalid cluster).

    ``dense`` is the (m, n) PCM; ``llrs`` the row's (n,) guiding LLRs;
    ``decoding`` the row's decoding, whose restriction to each final cluster
    is that cluster's solution. The LLRs are rounded to float32, the keys
    the decoders' growth sorts.
    """
    stats = stats if stats is not None else Statistics()
    m, n = tg.m, tg.n
    syndrome = np.asarray(syndrome).astype(np.uint8)
    if not syndrome.any():  # no clusters ever form
        stats.individual_cluster_stats = {}
        return stats
    if bits_per_step >= n:
        bits_per_step = 0  # every boundary bit joins: the same rule
    dev = tg.chk_bits.device
    syn = torch.as_tensor(syndrome[None, :], device=dev).contiguous()
    llr = torch.as_tensor(np.asarray(llrs, np.float32)[None, :], device=dev)
    rank = uf.llr_rank(llr)
    seed = syn == 1
    INF = uf.INF

    in_bit_np = np.zeros(n, bool)
    in_bit = torch.zeros((1, n), dtype=torch.bool, device=dev)
    cstats: Dict[int, ClusterStatistics] = {}
    # clusters are created one per flipped syndrome check (lsd.hpp:702-712)
    for c in np.flatnonzero(syndrome == 1):
        cstats[int(c)] = ClusterStatistics(
            cluster_id=int(c), active=True, size_history=[0]
        )

    def bit_labels(in_np, labels_np):
        t = torch.as_tensor(in_np[None, :], device=dev)
        lab = torch.as_tensor(labels_np[None, :], device=dev)
        return uf.bit_labels(tg, lab, t)[0].cpu().numpy()

    prev_labels = None
    labels = np.full(m, INF, np.int64)
    grew_last_round: set = set()
    timestep = 0
    while timestep < n + 1:
        labels_d, chk_invalid_d, new_in_d, joined_d = _stat_round(
            tg, in_bit, syn, llr, rank, seed, bits_per_step
        )
        labels, chk_invalid, new_in_np, joined = _host(
            labels_d, chk_invalid_d, new_in_d, joined_d
        )
        active_ids = set(int(c) for c in np.unique(labels[labels < INF]))
        # size history: the reference pushes a cluster's size after its
        # growth step and any merges it triggered (lsd.hpp:714-725); merges
        # only show in the next round's labels, so the append waits for them
        if grew_last_round:
            bl_now = bit_labels(in_bit_np, labels)
            for cid in grew_last_round:
                cs = cstats.get(cid)
                if cs is not None and cid in active_ids:
                    cs.size_history.append(int((bl_now == cid).sum()))
            grew_last_round = set()
        # merges: a previously active id that is no longer a label was
        # absorbed by its check's new label
        if prev_labels is not None:
            for cid, cs in cstats.items():
                if cs.active and cid not in active_ids and cid < m:
                    absorber = int(labels[cid])
                    cs.active = False
                    cs.got_inactive_in_timestep = timestep
                    cs.absorbed_by_cluster = absorber
                    if absorber in cstats:
                        cstats[absorber].nr_merges += 1
                    # membership frozen at absorption time
                    bl_prev = bit_labels(in_bit_np, prev_labels)
                    cs.final_bits = [int(b) for b in np.flatnonzero(bl_prev == cid)]
                    cs.final_bit_count = len(cs.final_bits)
        for cid in active_ids:
            cs = cstats.setdefault(
                cid, ClusterStatistics(cluster_id=cid, active=True, size_history=[0])
            )
            cluster_invalid = bool(chk_invalid[labels == cid].any())
            if not cluster_invalid and cs.got_valid_in_timestep < 0:
                cs.got_valid_in_timestep = timestep

        if not chk_invalid.any():
            break

        # the bits this timestep adds, grouped by the cluster they join
        added = new_in_np & ~in_bit_np
        if added.any():
            per_cluster: Dict[int, list] = {}
            for b in np.flatnonzero(added):
                per_cluster.setdefault(int(joined[b]), []).append(int(b))
            stats.global_timestep_bit_history[timestep] = per_cluster
            for cid in per_cluster:
                cs = cstats.get(cid)
                if cs is None or not cs.active:
                    continue
                cs.undergone_growth_steps += 1
                grew_last_round.add(cid)

        in_bit_np = new_in_np
        in_bit = new_in_d
        prev_labels = labels
        timestep += 1

    # final records of the clusters still active (lsd.hpp:660-676)
    final_bl = bit_labels(in_bit_np, labels)
    decoding = np.asarray(decoding).astype(np.uint8)
    for cid, cs in cstats.items():
        if not cs.active:
            continue
        bits = np.flatnonzero(final_bl == cid)
        cs.final_bits = [int(b) for b in bits]
        cs.final_bit_count = len(cs.final_bits)
        cs.solution = [int(decoding[b]) for b in bits]
        checks = np.flatnonzero(labels == cid)
        if bits.size and checks.size:
            nnz = int(dense[np.ix_(checks, bits)].sum())
            cs.nr_of_non_zero_check_matrix_entries = nnz
            cs.cluster_pcm_sparsity = 1.0 - nnz / float(bits.size * checks.size)
    stats.individual_cluster_stats = cstats
    return stats
