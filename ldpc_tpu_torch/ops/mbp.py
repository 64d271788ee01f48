"""Batched MBP (memory belief propagation) over GF(4) (port of
``ldpc_tpu.ops.mbp``; reference src_cpp/mbp.hpp, arXiv:2104.13659).

Pauli noise is decoded on the stabilizer matrix itself: each entry carries
a Pauli (1=X, 2=Y, 3=Z), and a qubit's error anticommutes with an entry
iff it is not the identity and differs from the entry's Pauli. Each
iteration sweeps the qubits in index order with immediate propagation. At
qubit j, for each of its stabilizers:

- every other entry g of the row contributes ``lam_g = log(1e-12 + (1 +
  e^{-q_g[P_g]}) / sum_{w != P_g} e^{-q_g[w]})`` of its qubit->stabilizer
  message ``q_g`` (3 values, one a Pauli);
- the stabilizer->qubit message is ``log((1+p)/(1-p))`` of the product
  ``p`` of their ``tanh(lam/2)`` in slot order, clipped to +-(1 - 1e-8)
  (product-sum), or ``gamma`` times their least ``|lam|`` (min-sum, the
  sign from the syndrome bit and the count of ``lam <= 0``), negated when
  the syndrome bit is 1;
- the posterior of Pauli w is ``chan[w] + sum_slots msg * (agree ? beta :
  1/alpha[w])``, summed in slot order from 0; the decision is the first
  least Pauli, or the identity when all three are positive;
- qubit j's new messages are ``llr_j`` on the agreeing Pauli and
  ``llr_j - msg`` on the others.

A lane converges when its decisions' syndrome equals its syndrome, tested
after each sweep, and then keeps its state.

Two observations shape the port (kernel K9', ``csrc/mbp.cu``):

- ``lam`` is a pure function of an edge's message and Pauli, and a qubit
  writes only its own edges, so each edge's combination value is computed
  once when its qubit writes it and cached: ``lam`` (min-sum) or
  ``tanh(lam/2)`` (product-sum). The messages themselves are never read
  again and need no storage. The cache is bit for bit what the sweep
  recomputes.
- Qubits that share no stabilizer commute in the sweep, so the sweep runs
  level by level (:func:`ldpc_tpu_torch.ops.bp_fold.serial_levels` on the
  index order, as K6' does).

:func:`mbp_reference` is the plain PyTorch version of the kernel, level by
level on tensors; :func:`make_mbp_decoder` runs it on the CPU and K9' on a
CUDA device.
"""

from typing import NamedTuple

import numpy as np
import scipy.sparse
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops.bp import torch_dtype
from ldpc_tpu_torch.ops.bp_fold import serial_levels
from ldpc_tpu_torch.ops.pcm import PcmGraph, compile_pcm

PRODUCT_SUM = 0
MINIMUM_SUM = 1

_BIG = 1e30


class Gf4Graph(NamedTuple):
    """Binary ELL layout + per-entry Pauli values (1=X, 2=Y, 3=Z)."""

    graph: PcmGraph
    chk_val: np.ndarray  # (m, dc) uint8, pad 0
    var_val: np.ndarray  # (n, dv) uint8, pad 0


def compile_gf4(Hgf4) -> Gf4Graph:
    """Build the GF(4) layout from a scipy/numpy matrix with entries in
    {0, 1, 2, 3}."""
    if scipy.sparse.issparse(Hgf4):
        dense = np.asarray(Hgf4.todense(), dtype=np.uint8)
    else:
        dense = np.asarray(Hgf4, dtype=np.uint8)
    graph = compile_pcm(scipy.sparse.csr_matrix((dense != 0).astype(np.uint8)))
    chk_val = np.where(
        graph.chk_mask, dense[np.arange(graph.m)[:, None], np.minimum(graph.chk_bits, graph.n - 1)], 0
    ).astype(np.uint8)
    var_val = np.where(
        graph.var_mask,
        dense[np.minimum(graph.var_chks, graph.m - 1), np.arange(graph.n)[:, None]],
        0,
    ).astype(np.uint8)
    return Gf4Graph(graph=graph, chk_val=chk_val, var_val=var_val)


def pauli_syndrome(dense_gf4: np.ndarray, error_gf4: np.ndarray) -> np.ndarray:
    """Symplectic (anticommutation) syndrome of a GF(4) error batch
    (mbp.hpp:43-56). ``error_gf4``: (..., n) with entries 0..3."""
    e = error_gf4[..., None, :]  # (..., 1, n)
    H = dense_gf4[None, :, :] if error_gf4.ndim > 1 else dense_gf4
    anti = (H != 0) & (e != 0) & (e != H)
    return anti.sum(axis=-1) % 2


class Gf4Torch(NamedTuple):
    """The GF(4) layout on a torch device, with the level schedule of the
    index order: level l (from 0) holds the qubits ``lv_bits[lv_ptr[l]:
    lv_ptr[l+1]]``, none of which shares a stabilizer with another.

    The real (qubit, slot) pairs of the schedule, which kernel K9' walks
    (the plain version does not read them): the qubit at level position i
    owns the pairs ``pairs[pair_ptr[i]:pair_ptr[i+1]]``, one for each of its
    real slots in slot order, so a level's pairs are qubit-major and no pad
    slot appears. A pair's row is (stabilizer, its own slot in the
    stabilizer's row, the qubit's level position, Pauli + 4 * the
    stabilizer's row degree)."""

    m: int
    n: int
    dc: int
    dv: int
    chk_bits: torch.Tensor  # (m, dc) int32, pad n
    chk_val: torch.Tensor  # (m, dc) uint8, pad 0
    var_chks: torch.Tensor  # (n, dv) int32, pad m
    var_slot: torch.Tensor  # (n, dv) int32
    var_val: torch.Tensor  # (n, dv) uint8, pad 0
    lv_bits: torch.Tensor  # (n,) int32
    lv_ptr: torch.Tensor  # (levels + 1,) int32
    max_level: int  # qubits of the widest level
    pair_ptr: torch.Tensor  # (n + 1,) int32, by level position
    pairs: torch.Tensor  # (edges, 4) int32
    max_pairs: int  # real pairs of the widest level

    @property
    def levels(self) -> int:
        return self.lv_ptr.shape[0] - 1


def level_pairs(g: PcmGraph, var_val: np.ndarray, bits: np.ndarray, ptr: np.ndarray):
    """The real (qubit, slot) pairs of a level schedule ``bits`` (level
    positions -> qubits) with level pointers ``ptr``, as :class:`Gf4Torch`
    holds them: ``(pair_ptr (n + 1,), pairs (edges, 4), max_pairs)``, int32.
    A qubit's real slots come first in the ELL layout, as a row's do."""
    deg = g.var_mask.sum(axis=1)[bits]  # real slots at each level position
    pair_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    pos = np.repeat(np.arange(g.n), deg)
    slot = np.arange(pair_ptr[-1]) - pair_ptr[pos]
    q = bits[pos]
    chk = g.var_chks[q, slot]
    row_deg = g.chk_mask.sum(axis=1)
    pairs = np.stack([chk, g.var_slot[q, slot], pos,
                      var_val[q, slot].astype(np.int64) + 4 * row_deg[chk]], axis=1)
    per_level = np.diff(pair_ptr[ptr])
    return pair_ptr, pairs.astype(np.int32), int(per_level.max()) if per_level.size else 0


def gf4_to_torch(g4: Gf4Graph, device) -> Gf4Torch:
    """Copy a :class:`Gf4Graph`, its level schedule and the schedule's real
    pairs onto ``device``."""
    g = g4.graph
    bits, ptr = serial_levels(g.var_chks, g.m, np.arange(g.n, dtype=np.int32))
    nlev = int(np.searchsorted(ptr[0], g.n))  # ptr[l] = n from the last level on
    ptr = ptr[0, : nlev + 1]
    pair_ptr, pairs, max_pairs = level_pairs(g, g4.var_val, bits[0], ptr)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return Gf4Torch(
        m=g.m, n=g.n, dc=g.dc, dv=g.dv,
        chk_bits=put(g.chk_bits, torch.int32),
        chk_val=put(g4.chk_val, torch.uint8),
        var_chks=put(g.var_chks, torch.int32),
        var_slot=put(g.var_slot, torch.int32),
        var_val=put(g4.var_val, torch.uint8),
        lv_bits=put(bits[0], torch.int32),
        lv_ptr=put(ptr, torch.int32),
        max_level=int(np.diff(ptr).max()) if nlev else 0,
        pair_ptr=put(pair_ptr, torch.int32),
        pairs=put(pairs, torch.int32),
        max_pairs=max_pairs,
    )


def mbp_params(channel, alpha, dtype, device):
    """The channel LLRs ``log((1-p)/p)`` and ``1/alpha``, each (3, n),
    computed in float64 on the host and rounded once to ``dtype``, as the
    JAX package does."""
    ch = np.asarray(channel, np.float64)
    with np.errstate(divide="ignore"):
        chan = np.log((1.0 - ch) / ch)
        inv_alpha = 1.0 / np.asarray(alpha, np.float64)
    return (torch.from_numpy(chan).to(device=device, dtype=dtype).contiguous(),
            torch.from_numpy(inv_alpha).to(device=device, dtype=dtype).contiguous())


def _edge_value(q: torch.Tensor, val: torch.Tensor, min_sum: bool) -> torch.Tensor:
    """The cached combination value of edges with messages ``q`` (..., 3)
    and Paulis ``val`` (...) in 1..3: ``lam`` (min-sum) or ``tanh(lam/2)``
    (product-sum)."""
    e = torch.exp(-q)
    w = torch.arange(1, 4, device=q.device)
    agree = val.long()[..., None] == w
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    num = torch.where(agree, e, zero).sum(dim=-1) + 1.0
    den = torch.where(agree, zero, e).sum(dim=-1)
    eps = torch.tensor(1e-12, dtype=q.dtype, device=q.device)
    lam = torch.log(eps + num / den)
    return lam if min_sum else torch.tanh(lam * 0.5)


def mbp_reference(
    g: Gf4Torch,
    syndromes: torch.Tensor,
    chan: torch.Tensor,
    inv_alpha: torch.Tensor,
    max_iter: int,
    beta: float,
    bp_method: int,
    gamma: float,
):
    """Plain PyTorch MBP on (B, m) uint8 syndromes, in the dtype of
    ``chan`` (float32 or float64), level by level over the lanes still
    running. Returns ``(decoding (B, n) uint8, llrs (B, 3, n), converged
    (B,) bool, iterations (B,) int32)``."""
    m, n, dc, dv = g.m, g.n, g.dc, g.dv
    E = m * dc
    B = syndromes.shape[0]
    dev, dt = syndromes.device, chan.dtype
    min_sum = bp_method == MINIMUM_SUM
    w_axis = torch.arange(1, 4, device=dev)
    chk_bits = g.chk_bits.long()
    chk_mask = chk_bits < n
    chk_val = g.chk_val.long()
    beta_t = torch.tensor(beta, dtype=dt, device=dev)
    gamma_t = torch.tensor(gamma, dtype=dt, device=dev)
    big = torch.tensor(_BIG, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    lim = torch.tensor(1e-8, dtype=dt, device=dev)
    chan_pad = torch.cat([chan, torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)

    # each real edge's initial message: the channel LLR of its qubit, 0 on
    # the agreeing Pauli; the cache holds its combination value
    q0 = torch.where(chk_val.reshape(-1, 1) == w_axis, zero, chan_pad[:, chk_bits.reshape(-1)].t())
    cache0 = torch.where(chk_mask.reshape(-1), _edge_value(q0, chk_val.reshape(-1), min_sum), zero)
    cache = torch.cat([cache0, zero.reshape(1)]).expand(B, E + 1).clone()  # column E: pad
    llr = torch.zeros((B, 3, n), dtype=dt, device=dev)
    dec = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    synd = syndromes.long()

    # each level's (qubit, slot) pairs, qubit-major, on the device
    lv_bits = g.lv_bits.long().cpu()
    lv_ptr = g.lv_ptr.cpu().tolist()
    levels = []
    slot = torch.arange(dc, device=dev)
    for lv in range(g.levels):
        q = lv_bits[lv_ptr[lv]:lv_ptr[lv + 1]].to(dev)  # (Q,)
        chk = g.var_chks.long()[q]  # (Q, dv), pad m
        real = chk < m
        own = g.var_slot.long()[q]
        c = chk.clamp(max=m - 1)
        row = torch.where(real[..., None], c[..., None] * dc + slot, E)  # (Q, dv, dc)
        others = real[..., None] & chk_mask[c] & (slot != own[..., None])
        edge = torch.where(real, c * dc + own, E)
        val = g.var_val.long()[q]  # (Q, dv)
        agree = val[..., None] == w_axis  # (Q, dv, 3)
        levels.append((q, chk, real, row, others, edge, val, agree))

    it = 0
    while it < max_iter and not bool(conv.all()):
        it += 1
        idx = torch.nonzero(~conv).squeeze(1)
        cch, s_l, ll, dd = cache[idx], synd[idx], llr[idx], dec[idx]
        L = idx.numel()
        for q, chk, real, row, others, edge, val, agree in levels:
            Q = q.numel()
            vals = cch[:, row.reshape(-1)].view(L, Q, dv, dc)
            s = torch.cat([s_l, torch.zeros((L, 1), dtype=s_l.dtype, device=dev)], 1)[:, chk]
            if min_sum:
                absl = torch.where(others, vals.abs(), big)
                mn = absl.min(dim=3).values
                negs = (others & (vals <= 0)).sum(dim=3)
                sgn = (s + negs) % 2
                msg = (1 - 2 * sgn).to(dt) * gamma_t * mn
            else:
                t = torch.where(others, vals, one)
                p = t[..., 0]
                for k in range(1, dc):
                    p = p * t[..., k]
                p = torch.clamp(p, -1 + lim, 1 - lim)
                msg = (1 - 2 * s).to(dt) * torch.log((1 + p) / (1 - p))
            msg = torch.where(real, msg, zero)  # (L, Q, dv)
            coef = torch.where(agree, beta_t, inv_alpha[:, q].t()[:, None, :])  # (Q, dv, 3)
            part = msg[..., None] * coef * real[..., None].to(dt)  # (L, Q, dv, 3)
            acc = torch.zeros((L, Q, 3), dtype=dt, device=dev)
            for k in range(dv):
                acc = acc + part[:, :, k]
            llr_q = chan[:, q].t() + acc  # (L, Q, 3)
            first = torch.argmin(llr_q, dim=2).to(torch.uint8) + 1
            dd[:, q] = torch.where((llr_q > 0).all(dim=2), 0, first).to(torch.uint8)
            ll[:, :, q] = llr_q.transpose(1, 2)
            q2s = llr_q[:, :, None, :] - torch.where(agree, zero, msg[..., None])
            new = _edge_value(q2s, val.clamp(min=1).expand(L, Q, dv), min_sum)
            cch[:, edge.reshape(-1)] = torch.where(real, new, zero).reshape(L, -1)
        # the decisions' Pauli syndrome against the syndrome
        d_pad = torch.cat([dd, torch.zeros((L, 1), dtype=dd.dtype, device=dev)], 1)
        db = d_pad[:, chk_bits].long()  # (L, m, dc)
        anti = chk_mask & (db != 0) & (db != chk_val)
        ok = ((anti.sum(dim=2) % 2) == s_l).all(dim=1)
        cch[:, E] = 0
        cache[idx], llr[idx], dec[idx] = cch, ll, dd
        iters[idx] = it
        conv[idx] = ok
    return dec, llr, conv, iters


def make_mbp_decoder(
    g4: Gf4Graph,
    channel: np.ndarray,
    max_iter: int,
    alpha: np.ndarray,
    beta: float,
    bp_method: int,
    gamma: float,
    device="cuda",
    dtype=torch.float64,
):
    """Build a batched MBP decoder on ``device``: kernel K9' on a CUDA
    device, its plain version on the CPU.

    ``channel`` and ``alpha`` are (3, n). Returns ``decode(syndromes: (B,
    m) uint8) -> (decoding_gf4: (B, n) uint8, llrs: (B, 3, n), converged:
    (B,) bool, iterations: (B,) int32)``.
    """
    from ldpc_tpu_torch.ops import mbp_cuda

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    g = gf4_to_torch(g4, device)
    chan, inv_alpha = mbp_params(channel, alpha, dtype, device)

    def decode(syndromes):
        syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device).contiguous()
        return mbp_cuda.mbp(g, syndromes, chan, inv_alpha, max_iter, beta, bp_method, gamma)

    return decode
