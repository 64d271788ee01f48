"""Overlapping-window BP+OSD-0 decoding of a detector error model,
computed plainly: the loop of the upstream ``_corr_multiple_rounds`` and
``current_round_inds`` (ldpc v2.4.1,
``src_python/ldpc/ckt_noise/base_overlapping_window_decoder.py``) with a
min-sum BP and an OSD-0 of its own in each window.

The DEM's ``H`` (detectors x mechanisms) holds ``num_checks`` detectors a
round. Window w of ``decodings`` takes the rows of its ``window`` rounds,
from round ``w * commit``; its commit rows are those of its first ``commit``
rounds. Its columns run from the least column of its commit rows to the
greatest of all its rows; it commits the columns up to the greatest of its
commit rows, and the last window commits all of its columns. Per window:

1. the syndrome is the shots' rows XOR the rows' syndrome of the
   corrections committed so far;
2. min-sum BP (``reference/bp.py``) with the window's priors: the DEM's,
   and 0 (an LLR of +inf) on the columns committed so far;
3. OSD-0 on the lanes BP leaves unconverged: the columns least reliable
   first (the stable ascending sort of the posterior, ties by column),
   Gauss-Jordan elimination of ``[H_w | s]`` in that order with the lowest
   unused row holding a 1 as each pivot, until no unused row holds a
   syndrome 1 or the rank is reached; the pivot columns take their rows'
   reduced syndrome and every other column 0;
4. the commit: the window's decoding on its commit columns is XORed into
   the running correction.

Departures from the upstream text, none of which changes a decoding:

- upstream hands each window's decoder every column of the DEM; here only
  the window's own. Every other column is zero in the window's rows: BP
  leaves it at its prior and decides 0, OSD-0 never pivots on it, and the
  window's columns keep their order among themselves in the sort;
- upstream XORs the syndrome of the whole running correction into the
  window's rows of the detector record after each window; here each
  window's syndrome is computed anew from the unaltered shots. With
  ``window <= 2 * commit`` a row lies in at most two windows and the two
  agree (the decoder refuses a longer window);
- upstream adds each window's commit into the correction (``+=``), here
  XOR: a column committed before has prior 0 and decodes to 0, so no
  column is set twice;
- a prior of 0 gives the LLR log((1 - 0) / 0) = +inf, as in upstream; in
  min-sum a +inf input is positive, sets no check's minimum while another
  input is finite, keeps the bit's posterior at +inf and its decision 0;
- upstream's OSD-0 factorises the window's matrix in its own pivot order;
  any pivot rule over the same column order picks the same pivot columns
  (the first ``rank`` independent ones) and so the same solution. The fast
  exit ends a lane whose reduced syndrome lies on its pivot rows: a later
  pivot would take a syndrome 0 and change nothing.

``dtype`` is float32 for the reference and bfloat16 for the control; BP's
arithmetic and the posterior's sort are in it. Float32 products run with
TF32 off. The work a roofline counts comes back with the decodings, window
by window: BP's lanes and lane-iterations (each lane to its convergence or
the cap), OSD-0's lanes, the columns each walks to the pivot that ends it,
its pivots and the words of its pivot rows (``ceil((steps + 1) / 32)``).
"""

import numpy as np
import torch

from benchmark.reference import bp, codes, osd

_WORD = 32
_OSD_CHUNK = 256  # lanes of one elimination: (lanes, n, m) uint8 columns in the lanes' order


def windows(H: np.ndarray, decodings: int, window: int, commit: int, num_checks: int) -> list:
    """Each window's ``(rows, lo, commit_hi, hi)``: its row slice and its
    first, last committed and last columns (``current_round_inds``)."""
    out = []
    for w in range(decodings):
        start = w * commit * num_checks
        commit_cols = np.flatnonzero(H[start : start + commit * num_checks].any(axis=0))
        cols = np.flatnonzero(H[start : start + window * num_checks].any(axis=0))
        out.append((slice(start, start + window * num_checks), int(commit_cols.min()),
                    int(commit_cols.max()), int(cols.max())))
    return out


def channel_llr(priors: np.ndarray) -> np.ndarray:
    """log((1 - p) / p) in float64, held in float32; +inf where p = 0."""
    p = np.asarray(priors, np.float64)
    with np.errstate(divide="ignore"):
        return np.log((1.0 - p) / p).astype(np.float32)


def osd0(Hw: torch.Tensor, syndromes: torch.Tensor, posterior: torch.Tensor, rank: int):
    """OSD-0 decodings (B, n) uint8 of ``syndromes`` (B, m) guided by
    ``posterior`` (B, n), and per lane the columns walked, the pivots and
    the pivot rows' words."""
    m, n = Hw.shape
    B = syndromes.shape[0]
    dev = syndromes.device
    order = osd.reliability_order(posterior.to(torch.float32))
    bits = torch.cat([Hw.t()[order].transpose(1, 2), syndromes[:, :, None]], dim=2)
    A = osd._pack(bits)  # (B, m, W): [H_w | s] in the lane's order, 32 columns a word
    del bits
    lanes = torch.arange(B, device=dev)
    rows = torch.arange(m, device=dev)
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    place = torch.full((B, m), n, dtype=torch.int64, device=dev)  # pivot's place in the order
    pivots = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(n):
        sbit = ((A[:, :, n // _WORD] >> (n % _WORD)) & 1).bool()
        active = (pivots < rank) & (sbit & ~used).any(dim=1)
        if j % _WORD == 0 and not bool(active.any()):
            break
        col = ((A[:, :, j // _WORD] >> (j % _WORD)) & 1).bool() & active[:, None]
        cand = col & ~used
        has = cand.any(dim=1)
        piv = cand.to(torch.uint8).argmax(dim=1)  # the lowest unused row with a 1
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        prow = A[lanes, piv]
        elim = col & ~is_piv & has[:, None]
        A = A ^ torch.where(elim[:, :, None], prow[:, None, :], zero)
        used = used | is_piv
        place = torch.where(is_piv, j, place)
        pivots = pivots + has.to(torch.int64)
        steps = torch.where(has, j + 1, steps)
    y = ((A[:, :, n // _WORD] >> (n % _WORD)) & 1).to(torch.uint8) * used
    x_in_order = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    x_in_order.scatter_(1, place, y)
    x = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    x.scatter_(1, order, x_in_order[:, :n])
    return x, steps, pivots, pivots * ((steps + _WORD) // _WORD)


def decode(H: np.ndarray, priors: np.ndarray, shots: torch.Tensor, decodings: int, window: int,
           commit: int, num_checks: int, max_iter: int, alpha: float, dtype=torch.float32):
    """The corrections (B, N) uint8 of the shots' detectors (B, D) uint8,
    on their device, and the work of each window (a list of dicts)."""
    if window > 2 * commit:
        raise ValueError("the reference takes windows of at most twice the commit")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = shots.device
    B = shots.shape[0]
    H = np.asarray(H, np.uint8)
    base = np.asarray(priors, np.float64).copy()
    total = torch.zeros((B, H.shape[1]), dtype=torch.uint8, device=dev)
    ranks, work = {}, []
    for w, (rows, lo, commit_hi, hi) in enumerate(windows(H, decodings, window, commit,
                                                           num_checks)):
        Hw_np = H[rows, lo : hi + 1]
        key = Hw_np.tobytes()
        if key not in ranks:
            ranks[key] = codes.rank(Hw_np)
        Hw = torch.from_numpy(Hw_np).to(dev)
        # the committed corrections' syndrome: 0/1 sums of a row's weight, exact in float32
        adj = (total[:, lo : hi + 1].to(torch.float32) @ Hw.t().to(torch.float32)) % 2
        syn = shots[:, rows] ^ adj.to(torch.uint8)
        g = bp.graph(Hw_np, dev)
        llr = torch.from_numpy(channel_llr(base[lo : hi + 1])).to(dev)
        r = bp.min_sum(g, syn, llr, alpha, max_iter, dtype)
        x = r.decoding.clone()
        failed = torch.nonzero(~r.converged).squeeze(1)
        k = {"m": g.m, "n": g.n, "dc": g.dc, "dv": g.dv, "nnz": int(Hw_np.sum()),
             "bp_lanes": B, "bp_lane_iterations": int(r.iterations.sum()),
             "osd_lanes": int(failed.numel()), "osd_steps": 0, "osd_pivots": 0,
             "osd_pivot_words": 0}
        for a in range(0, failed.numel(), _OSD_CHUNK):
            idx = failed[a : a + _OSD_CHUNK]
            xo, steps, piv, words = osd0(Hw, syn[idx], r.posterior[idx], ranks[key])
            x[idx] = xo
            k["osd_steps"] += int(steps.sum())
            k["osd_pivots"] += int(piv.sum())
            k["osd_pivot_words"] += int(words.sum())
        end = hi if w == decodings - 1 else commit_hi
        total[:, lo : end + 1] ^= x[:, : end + 1 - lo]
        base[lo : end + 1] = 0.0
        work.append(k)
    return total, work
