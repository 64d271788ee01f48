"""Plain PyTorch ordered-statistics decoding over GF(2).

Each lane takes its columns in its own order, least reliable first (the
stable ascending sort of its BP posterior, ties by column index), and
brings ``[H | s]`` to reduced row echelon form in that order by
Gauss-Jordan elimination. The pivot columns are the first ``rank``
linearly independent columns of the order; which row holds a pivot does
not change any result.

- OSD-CS of order w (the combination sweep of Roffe et al.,
  arXiv:2005.07016, as the ldpc package enumerates it): candidates flip
  one non-pivot column (each of them, least reliable first) or two of the
  w least reliable non-pivot columns (in the order (0, 1), (0, 2), ...,
  (w-2, w-1)); a candidate's pivot part is the reduced syndrome XOR the
  reduced columns it flips. With the channel of one error rate every
  candidate's score is its weight, and the first candidate of least weight,
  the OSD-0 solution (the pivot columns take the reduced syndrome, every
  other column 0) first, wins.

The elimination also counts the work a roofline needs: the columns a lane
walks to its last pivot.

The matrix is packed 32 columns to an int64 word, the columns in the
lane's order and the syndrome after them.
"""

from typing import NamedTuple

import torch

_WORD = 32


class Elimination(NamedTuple):
    words: torch.Tensor  # (B, m, W) int64: reduced [H | s] in the lane's order
    used: torch.Tensor  # (B, m) bool: rows holding a pivot
    pivot_of_row: torch.Tensor  # (B, m) int64: the pivot's place in the order, -1 if unused
    last_steps: torch.Tensor  # (B,) int64: columns walked to the last pivot


def reliability_order(posterior: torch.Tensor) -> torch.Tensor:
    """Columns least reliable first: stable ascending sort of the posterior."""
    return torch.argsort(posterior, dim=1, stable=True)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., k) 0/1 -> (..., ceil(k/32)) int64 words, bit j of word j // 32."""
    k = bits.shape[-1]
    W = -(-k // _WORD)
    shifts = torch.arange(_WORD, device=bits.device, dtype=torch.int64)
    words = torch.empty((*bits.shape[:-1], W), dtype=torch.int64, device=bits.device)
    for w in range(W):
        part = bits[..., w * _WORD : (w + 1) * _WORD].to(torch.int64)
        words[..., w] = (part << shifts[: part.shape[-1]]).sum(dim=-1)
    return words


def _unpack(words: torch.Tensor, k: int) -> torch.Tensor:
    bits = torch.empty((*words.shape[:-1], k), dtype=torch.bool, device=words.device)
    shifts = torch.arange(_WORD, device=words.device, dtype=torch.int64)
    for w in range(words.shape[-1]):
        lo, hi = w * _WORD, min(k, (w + 1) * _WORD)
        if lo < hi:
            bits[..., lo:hi] = ((words[..., w, None] >> shifts[: hi - lo]) & 1).bool()
    return bits


def eliminate(H: torch.Tensor, syndromes: torch.Tensor, order: torch.Tensor, rank: int) -> Elimination:
    """Gauss-Jordan of each lane's ``[H[:, order] | s]`` to ``rank`` pivots."""
    m, n = H.shape
    B = syndromes.shape[0]
    dev = syndromes.device
    cols = H.t()[order]  # (B, n, m): the lane's columns in its order
    bits = torch.cat([cols.transpose(1, 2), syndromes[:, :, None]], dim=2)
    A = _pack(bits)
    lanes = torch.arange(B, device=dev)
    rows = torch.arange(m, device=dev)
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    pivot_of_row = torch.full((B, m), -1, dtype=torch.int64, device=dev)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    last_steps = torch.zeros(B, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(n):
        if j % _WORD == 0 and bool((count >= rank).all()):
            break
        col = ((A[:, :, j // _WORD] >> (j % _WORD)) & 1).bool()
        cand = col & ~used
        has = cand.any(dim=1) & (count < rank)
        piv = cand.to(torch.uint8).argmax(dim=1)  # first unused row with a 1
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        prow = A[lanes, piv]
        elim = col & ~is_piv & has[:, None]
        A = A ^ torch.where(elim[:, :, None], prow[:, None, :], zero)
        used = used | is_piv
        pivot_of_row = torch.where(is_piv, j, pivot_of_row)
        count = count + has.to(torch.int64)
        last_steps = torch.where(has, j + 1, last_steps)
    return Elimination(A, used, pivot_of_row, last_steps)


def _syndrome_bits(e: Elimination, n: int) -> torch.Tensor:
    return ((e.words[:, :, n // _WORD] >> (n % _WORD)) & 1).bool()


def _to_original(x_in_order: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    x = torch.zeros_like(x_in_order)
    return x.scatter_(1, order, x_in_order)


def _solution(e: Elimination, y: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) uint8 in the lane's order: each pivot column takes its row of ``y``."""
    B = y.shape[0]
    x = torch.zeros((B, n + 1), dtype=torch.uint8, device=y.device)
    target = torch.where(e.used, e.pivot_of_row, n)
    x.scatter_(1, target, (y & e.used).to(torch.uint8))
    return x[:, :n]


def osd_cs(H, syndromes, order, rank, osd_order: int, chunk: int = 512):
    """OSD-CS decodings (B, n) uint8 and the elimination's work counts."""
    n = H.shape[1]
    e = eliminate(H, syndromes, order, rank)
    parts = [_sweep(Elimination(*(t[a : a + chunk] for t in e)), n, osd_order)
             for a in range(0, syndromes.shape[0], chunk)]
    x = torch.cat(parts) if parts else torch.zeros((0, n), dtype=torch.uint8, device=H.device)
    return _to_original(x, order), e


def _first_min(score: torch.Tensor):
    low = score.min(dim=1).values
    idx = torch.arange(score.shape[1], device=score.device)
    first = torch.where(score == low[:, None], idx, score.shape[1]).min(dim=1).values
    return low, first


def _sweep(e: Elimination, n: int, osd_order: int) -> torch.Tensor:
    B, m = e.used.shape
    dev = e.used.device
    lanes = torch.arange(B, device=dev)
    s = _syndrome_bits(e, n) & e.used
    R = _unpack(e.words, n) & e.used[:, :, None]  # (B, m, n) reduced columns
    ispiv = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    ispiv.scatter_(1, torch.where(e.used, e.pivot_of_row, n), True)
    k = int((~ispiv[:, :n]).sum(dim=1).min()) if B else 0
    # non-pivot columns in the order (least reliable first)
    nonpiv = torch.argsort(ispiv[:, :n].to(torch.uint8), dim=1, stable=True)[:, :k]
    R_np = torch.gather(R, 2, nonpiv[:, None, :].expand(B, m, k))  # (B, m, k)
    best = s.sum(dim=1)
    single = (s[:, :, None] ^ R_np).sum(dim=1) + 1  # (B, k)
    low1, j1 = _first_min(single) if k else (best, torch.zeros_like(best))
    take1 = low1 < best
    best = torch.where(take1, low1, best)
    w = min(osd_order, k)
    pairs = [(a, b) for a in range(w) for b in range(a + 1, w)]
    flips = torch.full((B, 2), -1, dtype=torch.int64, device=dev)
    flips[:, 0] = torch.where(take1, j1, -1)
    if pairs:
        pa = torch.tensor([p[0] for p in pairs], device=dev)
        pb = torch.tensor([p[1] for p in pairs], device=dev)
        Y = s[:, :, None] ^ R_np[:, :, pa] ^ R_np[:, :, pb]  # (B, m, P)
        lowp, jp = _first_min(Y.sum(dim=1) + 2)
        takep = lowp < best
        flips[:, 0] = torch.where(takep, pa[jp], flips[:, 0])
        flips[:, 1] = torch.where(takep, pb[jp], -1)
    y = s.clone()
    x_flip = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    for f in range(2):
        on = flips[:, f] >= 0
        j = flips[:, f].clamp(min=0)
        y = y ^ (R_np[lanes, :, j] & on[:, None])
        x_flip.scatter_(1, torch.where(on, nonpiv[lanes, j], n)[:, None], 1)
    return _solution(e, y, n) | x_flip[:, :n]
