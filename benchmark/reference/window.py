"""Sliding-window decoding of recorded syndrome histories, computed
plainly: upstream's ``decode_multiround`` (ldpc v2.4.1,
``src_python/ldpc/monte_carlo_simulation/memory_experiment_v2.py:12-41`` and
``73-160``, the ``analog_tg`` mode of ``quasi_single_shot_v2.py``) over a
history of R rounds, in windows of W rounds sliding by T = W // 2, with a
min-sum BP and an OSD-0 in each window.

A shot is a (m, R) uint8 history of syndromes whose last round is
perfect and, in analog mode, its (m, R) float32 analog values ``a`` (the
syndrome bit is ``a < 0``; the last round's values are exactly
``1 - 2 s``). Window w takes rounds [w T, w T + W). In each window:

1. the carries: the syndrome of the correction committed so far is XORed
   into every round of the window, and the time-boundary bits that the
   window before left into its first round;
2. the difference syndromes along the rounds (round 0 as it is, round r
   XOR round r - 1), round-major;
3. the prior on the window's space-time matrix (:func:`space_time`: W
   blocks of H on the diagonal, then W blocks of m time-like columns, each
   on its round's checks and the next round's): the data bits' channel
   LLR; the time-like bits' channel LLR or, in analog mode, ``|a c|`` with
   ``c = f32(2) * (f32(1) / (sigma * sigma))``; in the last window the
   time-like bits of its last round pinned at the LLR of
   ``last_round_rate``;
4. min-sum BP (:func:`min_sum`: ``reference/bp.py``'s recurrence with a
   prior a lane);
5. OSD-0 (``reference/owd.py``'s ``osd0``) on the lanes BP leaves
   unconverged;
6. the commit: the XOR of the data bits of the first T rounds (of all W in
   the last window) into the total correction; the time-like bits of round
   T - 1 are the next window's time-boundary bits.

Departures from the upstream text:

- upstream turns each analog LLR into a probability ``1 / (e^|l| + 1)``
  (``get_virtual_check_init_vals``) that its decoder turns back into an
  LLR in float64; here the LLR is ``|a c|`` in float32 with ``c`` as above,
  each step rounded in float32, which is how the program under test
  defines it;
- upstream adds the committed correction's syndrome to the window's
  tentative rounds only, because its simulator applies the correction to
  the device's error, so later rounds never show it; a recorded history is
  not corrected at the source, so here the syndrome is carried into every
  later round. The time-boundary bit is upstream's;
- upstream's OSD-0 factorises in its own pivot order; any pivot rule over
  the same column order picks the same pivot columns and so the same
  solution (``reference/owd.py``);
- BP and the priors run in ``dtype``: float32 for the reference, bfloat16
  for the control. Float32 products run with TF32 off.

The work a roofline counts comes back window by window, in
``reference/owd.py``'s format: BP's lanes and lane-iterations, OSD-0's
lanes, the columns each walks, its pivots and its pivot rows' words.
"""

from typing import Optional

import numpy as np
import torch

from benchmark.reference import bp, codes, owd

_OSD_CHUNK = 1024  # lanes of one OSD-0 elimination


def sigma_from_rate(q: float) -> float:
    """The analog noise's sigma whose hard decision flips a syndrome bit
    at rate ``q``: ``1 / sqrt(2) / erfcinv(2 q)`` (upstream's
    ``get_sigma_from_syndr_er``)."""
    from scipy.special import erfcinv

    return float(1.0 / np.sqrt(2.0) / erfcinv(2.0 * q))


def analog_scale(sigma: float) -> np.float32:
    """``f32(2) * (f32(1) / (sigma * sigma))``, each step in float32."""
    s = np.float32(sigma)
    return np.float32(2.0) * (np.float32(1.0) / (s * s))


def space_time(H: np.ndarray, W: int) -> np.ndarray:
    """The window's (W m, W n + W m) 0/1 matrix in upstream's column order:
    H on the diagonal, then time-like column j of round r on check j of
    rounds r and r + 1."""
    H = np.asarray(H, np.uint8) % 2
    m, n = H.shape
    out = np.zeros((W * m, W * (n + m)), np.uint8)
    eye = np.eye(m, dtype=np.uint8)
    for r in range(W):
        rows = slice(r * m, (r + 1) * m)
        out[rows, r * n : (r + 1) * n] = H
        out[rows, W * n + r * m : W * n + (r + 1) * m] = eye
        if r:
            out[rows, W * n + (r - 1) * m : W * n + r * m] = eye
    return out


def min_sum(g: bp.Graph, syndromes: torch.Tensor, llr: torch.Tensor, alpha: float,
            max_iter: int, dtype=torch.float32) -> bp.BpOut:
    """``reference/bp.py``'s ``min_sum`` with a (B, n) prior, a row a lane:
    the same operations in the same order; each lane's row is compacted
    with the lane."""
    B = syndromes.shape[0]
    dev = syndromes.device
    out = bp.BpOut(
        torch.zeros((B, g.n), dtype=torch.uint8, device=dev),
        torch.zeros((B, g.n), dtype=dtype, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev),
    )
    chunk = max(1, bp._CHUNK_ELEMENTS // (g.m * g.dc))
    for a in range(0, B, chunk):
        _run(g, syndromes[a : a + chunk], llr[a : a + chunk], alpha, max_iter, dtype, out, a)
    return out


def _run(g, syn, llr, alpha, max_iter, dtype, out, offset):
    dev = syn.device
    m, n, dc = g.m, g.n, g.dc
    llr = llr.to(device=dev, dtype=torch.float32).to(dtype)
    alpha_t = torch.tensor(alpha, dtype=dtype, device=dev)
    big = torch.tensor(bp._BIG, dtype=dtype, device=dev)
    slot = torch.arange(dc, device=dev)[None, None, :]
    mask = g.chk_mask[None]
    s = syn.to(torch.int64)
    lanes = torch.arange(syn.shape[0], device=dev) + offset  # rows of `out` still running
    post = llr
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
        lanes, post, c2v, s, llr = lanes[keep], post[keep], c2v[keep], s[keep], llr[keep]


class Decoder:
    """The windows of ``H``'s histories of ``rounds`` rounds: windows of
    ``window`` rounds, data and time-like channel rates ``p`` and ``q``,
    analog mode where ``sigma`` is given."""

    def __init__(self, H: np.ndarray, rounds: int, window: int, p: float, q: float,
                 sigma: Optional[float], max_iter: int, alpha: float, device,
                 last_round_rate: float = 1e-15, dtype=torch.float32):
        if window % 2 or rounds < window or (rounds - window) % (window // 2):
            raise ValueError(f"{rounds} rounds do not tile into windows of {window}")
        torch.backends.cuda.matmul.allow_tf32 = False
        self.H = np.asarray(H, np.uint8) % 2
        self.m, self.n = self.H.shape
        self.W, self.T = window, window // 2
        self.windows = (rounds - window) // self.T + 1
        self.max_iter, self.alpha, self.dtype, self.device = max_iter, alpha, dtype, device
        A = space_time(self.H, window)
        self.A = torch.from_numpy(A).to(device)
        self.g = bp.graph(A, device)
        self.rank = codes.rank(A)
        self.nnz = int(A.sum())
        self.Ht = torch.from_numpy(self.H.T.astype(np.float32)).to(device)
        f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)  # noqa: E731
        W, m, n = window, self.m, self.n
        self.data = f32(owd.channel_llr(np.full(W * n, p)))
        self.time = f32(owd.channel_llr(np.full(W * m, q)))
        self.pin = f32(owd.channel_llr(np.asarray([last_round_rate])))[0]
        self.scale = None if sigma is None else f32(analog_scale(sigma))

    def prior(self, last: bool, analog: Optional[torch.Tensor], B: int) -> torch.Tensor:
        """The window's (B, W n + W m) float32 prior; ``analog`` is the
        window's (B, m, W) values, or None."""
        m, W = self.m, self.W
        if analog is None:
            time = self.time.expand(B, W * m)
        else:
            time = (analog.transpose(1, 2).reshape(B, W * m) * self.scale).abs()
        if last:
            time = time.clone()
            time[:, (W - 1) * m :] = self.pin
        return torch.cat([self.data.expand(B, W * self.n), time], dim=1)

    def decode(self, syndromes: torch.Tensor, analog: Optional[torch.Tensor] = None):
        """``(total correction (B, n) uint8, iterations summed over the
        windows (B,) int64, each window's work)`` of the (B, m, R) uint8
        histories and, in analog mode, their (B, m, R) float32 values."""
        if (analog is None) != (self.scale is None):
            raise ValueError("analog values go with sigma, and only with it")
        m, n, W, T = self.m, self.n, self.W, self.T
        B = syndromes.shape[0]
        dev = syndromes.device
        carry = torch.zeros((B, m), dtype=torch.uint8, device=dev)
        boundary = torch.zeros((B, m), dtype=torch.uint8, device=dev)
        total = torch.zeros((B, n), dtype=torch.uint8, device=dev)
        iterations = torch.zeros(B, dtype=torch.int64, device=dev)
        work = []
        for w in range(self.windows):
            last = w == self.windows - 1
            rounds = slice(w * T, w * T + W)
            s = syndromes[:, :, rounds] ^ carry[:, :, None]
            s[:, :, 0] ^= boundary
            diff = s.clone()
            diff[:, :, 1:] ^= s[:, :, :-1]
            syn = diff.transpose(1, 2).reshape(B, W * m)
            prior = self.prior(last, None if analog is None else analog[:, :, rounds], B)
            r = min_sum(self.g, syn, prior, self.alpha, self.max_iter, self.dtype)
            x = r.decoding.clone()
            failed = torch.nonzero(~r.converged).squeeze(1)
            k = {"m": self.g.m, "n": self.g.n, "dc": self.g.dc, "dv": self.g.dv,
                 "nnz": self.nnz, "bp_lanes": B, "bp_lane_iterations": int(r.iterations.sum()),
                 "osd_lanes": int(failed.numel()), "osd_steps": 0, "osd_pivots": 0,
                 "osd_pivot_words": 0}
            for a in range(0, failed.numel(), _OSD_CHUNK):
                idx = failed[a : a + _OSD_CHUNK]
                xo, steps, piv, words = owd.osd0(self.A, syn[idx], r.posterior[idx], self.rank)
                x[idx] = xo
                k["osd_steps"] += int(steps.sum())
                k["osd_pivots"] += int(piv.sum())
                k["osd_pivot_words"] += int(words.sum())
            commit = x[:, : W * n].reshape(B, W, n)[:, : W if last else T].sum(dim=1) % 2
            commit = commit.to(torch.uint8)
            boundary = x[:, W * n :].reshape(B, W, m)[:, T - 1].contiguous()
            total ^= commit
            # 0/1 sums of a row's weight: exact in float32
            carry ^= ((commit.to(torch.float32) @ self.Ht) % 2).to(torch.uint8)
            iterations += r.iterations
            work.append(k)
        return total, iterations, work
