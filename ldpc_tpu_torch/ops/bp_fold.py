"""Kernels K6', K7' and K8': the fold-exact BP engines (``csrc/bp_fold.cu``;
K8' ``csrc/bp_exact.cu``).

Counterparts of three XLA loops of ``ldpc_tpu/ops/bp.py`` (none is a Pallas
kernel):

- K6' serial BP, ``make_serial_decoder``: bits update one at a time, in a
  given order, in one permutation per iteration from a table (random
  serial), or ranked by the lane's posteriors each iteration
  (serial-relative); min-sum or product-sum, float32 or float64.
- K7' soft-information BP, ``make_soft_info_decoder``: serial min-sum in
  index order over scaled soft syndromes with the virtual-update rules;
  returns the final soft syndrome too.
- K8' fold-exact parallel BP, ``_make_parallel_decoder_exact``: float64.

For each: ``*_reference`` is the plain PyTorch version, the reference's
steps in its order, vectorised over the batch; ``*_cuda`` launches the
kernel on CUDA tensors and counts the launch in :data:`LAUNCHES` and, by
where the lanes' state lived, in :data:`STATE_LAUNCHES`; the name without a
suffix picks by the tensors' device: the CPU runs the plain version, a CUDA
device the kernel, anything else raises.

K6' and K7' sweep by levels (:func:`serial_levels`, the plain model of the
kernels' schedule): bits that share no check commute in a serial sweep, so
the kernels update a level's bits together and equal the sequential sweep
bit for bit. :func:`relative_order_reference` is the plain model of
serial-relative's sort.

K8' is bound on the card by the instructions a lane-iteration issues, not
by its lanes' residency (measured: PERF.md), so its kernel spends
registers and shared memory on fewer instructions: one warp a lane,
eight lanes a block, each warp claiming its next lane when one is done;
the block's copy of the graph's indices in shared memory; a lane's
messages and decision bytes in shared memory, its posteriors and
decisions straight to the outputs; iteration 1 reads the channel LLRs in
place of initial messages; the syndrome test rides on the next check
pass; a check's row and a bit's column are read once an iteration into
registers (see the source's notes).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, BpResult
from ldpc_tpu_torch.ops.pcm import TorchGraph

# kernel launches made by the *_cuda wrappers, and by where the lanes' state
# lived (see state_variant)
LAUNCHES = {"bp_serial": 0, "bp_soft_info": 0, "bp_parallel_exact": 0}
STATE_LAUNCHES = {k: {"shared": 0, "device": 0} for k in LAUNCHES}

# K6's schedules: a given (n,) order, an (iterations, n) table of
# permutations (random serial), or the lane's posteriors ranked most
# reliable first at the start of each iteration
ORDER_FIXED = 0
ORDER_TABLE = 1
ORDER_RELATIVE = 2

_ENGINE = {"bp_serial": 0, "bp_soft_info": 1, "bp_parallel_exact": 2}
_BIG = 1e30  # magnitude of absent slots in the min-sum reductions
_MAX_DC = 32  # K8' product-sum keeps a row in registers
_FLOATS = (torch.float32, torch.float64)


def _alpha(bp_method, ms_scaling_factor, it, dtype, dev, dynamic=True):
    """The min-sum factor of iteration ``it``: fixed, or 1 - 2^-it when the
    factor is 0 (rounded once in ``dtype``)."""
    if dynamic and bp_method == MINIMUM_SUM and ms_scaling_factor == 0.0:
        return torch.tensor(1.0 - 2.0**-it, dtype=dtype, device=dev)
    return torch.tensor(ms_scaling_factor, dtype=dtype, device=dev)


def _clip(p):
    """The product-sum clip away from +-1, float32 only: float64 keeps the
    saturation to inf."""
    if p.dtype != torch.float32:
        return p
    eps = torch.tensor(1e-7, dtype=torch.float32, device=p.device)
    return torch.clamp(p, -1 + eps, 1 - eps)


def _fold_bit(llr0, c2v, vmask):
    """A bit's posterior (channel LLR plus its c2v in slot order) and its
    bit-to-check messages (the slots before, left fold, plus the slots
    after, folded from the last down): (B,), (B, dv), (B, dv) -> (B,),
    (B, dv)."""
    dv = c2v.shape[1]
    acc = llr0
    partials = []
    for k in range(dv):
        partials.append(acc)
        acc = torch.where(vmask[:, k], acc + c2v[:, k], acc)
    suf = torch.zeros_like(llr0)
    slots = [None] * dv
    for k in reversed(range(dv)):
        slots[k] = partials[k] + suf
        suf = torch.where(vmask[:, k], suf + c2v[:, k], suf)
    return acc, torch.stack(slots, dim=1)


class Levels(NamedTuple):
    """The level schedule of serial sweeps, one row per order, as a CSR:
    level l (counted from 1) of row r is ``bits[r, ptr[r, l-1]:ptr[r, l]]``,
    its bits in order position; ``ptr[r, l] = n`` from the row's last level
    on. ``bits`` (R, n) and ``ptr`` (R, n + 1) int32."""

    bits: torch.Tensor
    ptr: torch.Tensor

    def counts(self) -> torch.Tensor:
        """(R,) the number of levels of each row."""
        n = self.bits.shape[1]
        return (self.ptr[:, :n] < n).sum(dim=1)


def serial_levels(var_chks: np.ndarray, m: int, orders) -> tuple:
    """Split serial sweeps into levels (plain, numpy, on the host).

    ``orders``: (n,) or (R, n) permutations of the bits; ``var_chks``: (n,
    dv) each bit's checks, pad ``m``. A position's level is 1 + the highest
    level of an earlier bit of its order that shares a check with it
    (``level(j) = 1 + max(last[c] for c in checks(j))``, then ``last[c] =
    level(j)``), so no two bits of a level share a check and sweeping the
    levels in turn, a level's bits in any order, equals the sweep in the
    order. Returns (bits (R, n), ptr (R, n + 1)) int32 as :class:`Levels`
    holds them."""
    orders = np.atleast_2d(np.asarray(orders, dtype=np.int32))
    R, n = orders.shape
    rows = np.arange(R)[:, None]
    last = np.zeros((R, m + 1), dtype=np.int32)  # column m: the pad check
    level = np.zeros((R, n), dtype=np.int32)
    for pos in range(n):
        chks = var_chks[orders[:, pos]]
        lv = last[rows, chks].max(axis=1) + 1 if chks.shape[1] else np.ones(R, np.int32)
        last[rows, chks] = lv[:, None]
        last[:, m] = 0
        level[:, pos] = lv
    bits = np.take_along_axis(orders, np.argsort(level, axis=1, kind="stable"), axis=1)
    counts = np.zeros((R, n + 1), dtype=np.int32)
    np.add.at(counts, (np.broadcast_to(rows, level.shape), level), 1)
    return bits, np.cumsum(counts, axis=1, dtype=np.int32)


def level_schedule(tg: TorchGraph, order: torch.Tensor) -> Levels:
    """The :class:`Levels` of an (n,) order (one row) or an (R, n) table of
    orders (a row each), on ``order``'s device; computed on the host from a
    copy of ``order``."""
    bits, ptr = serial_levels(tg.var_chks.cpu().numpy(), tg.m, order.cpu().numpy())
    return Levels(torch.from_numpy(bits).to(order.device),
                  torch.from_numpy(ptr).to(order.device))


def _order_keys(post: torch.Tensor) -> torch.Tensor:
    """Serial-relative's sort keys: -post mapped monotonically to a signed
    int64 (+0 and -0 equal, every NaN above every number), the order
    ``bp_fold.cu``'s unsigned keys give."""
    neg = -post
    if post.dtype == torch.float32:
        i = neg.view(torch.int32).to(torch.int64)
        top = 2**31 - 1
    else:
        i = neg.view(torch.int64)
        top = 2**63 - 1
    key = torch.where(i >= 0, i, i ^ top)
    key = torch.where(neg == 0, torch.zeros_like(key), key)
    return torch.where(torch.isnan(neg), torch.full_like(key, top), key)


def relative_order_reference(post: torch.Tensor) -> torch.Tensor:
    """The plain model of K6''s serial-relative sort: each row's (key,
    index) pairs, padded to a power of two with keys above NaN, through the
    kernel's bitonic network; the index breaks ties. Returns (B, n) int64,
    which equals ``torch.argsort(-post, dim=1, stable=True)``."""
    B, n = post.shape
    P = 1 << max(0, (n - 1).bit_length())
    top = torch.iinfo(torch.int64).max
    key = torch.full((B, P), top, dtype=torch.int64, device=post.device)
    key[:, :n] = _order_keys(post)
    idx = torch.arange(P, device=post.device).expand(B, P).clone()
    i = torch.arange(P // 2, device=post.device)
    k = 2
    while k <= P:
        j = k // 2
        while j:
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            hi = lo | j
            ka, kb, ia, ib = key[:, lo], key[:, hi], idx[:, lo], idx[:, hi]
            greater = (ka > kb) | ((ka == kb) & (ia > ib))
            swap = greater == ((lo & k) == 0)[None, :]
            key[:, lo], key[:, hi] = torch.where(swap, kb, ka), torch.where(swap, ka, kb)
            idx[:, lo], idx[:, hi] = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
            j //= 2
        k *= 2
    return idx[:, :n]


class _SerialGraph:
    """The per-bit views a serial sweep reads, shared by every lane: each
    bit's edges (pad slots to a dump entry past the messages' zero pad
    row), checks, row slots and mask. Messages are (B, m*dc + dc + 1)
    check-major: the pad check m reads the zero pad row."""

    def __init__(self, tg: TorchGraph, init_llr: torch.Tensor):
        m, dc = tg.m, tg.dc
        dev = init_llr.device
        self.tg, self.init_llr = tg, init_llr
        self.slots = torch.arange(dc, device=dev)
        self.chk_bits = tg.chk_bits.reshape(-1).long()
        self.chk_mask_pad = torch.cat(
            [tg.chk_mask, torch.zeros((1, dc), dtype=torch.bool, device=dev)]
        )
        self.var_mask = tg.var_mask
        self.var_edges = torch.where(self.var_mask, tg.var_edges.long(), m * dc + dc)
        self.var_chks = tg.var_chks.long()
        self.var_slot = torch.where(self.var_mask, tg.var_edges.long() % max(dc, 1), 0)
        self.big = torch.tensor(_BIG, dtype=init_llr.dtype, device=dev)

    def lanes(self, B: int) -> dict:
        """The lanes' starting state: messages at their bits' channel LLRs,
        posteriors at the channel LLRs, decisions 0."""
        llr0 = self.init_llr
        v2c0 = torch.cat([torch.cat([llr0, llr0.new_zeros(1)])[self.chk_bits],
                          llr0.new_zeros(self.tg.dc + 1)])
        return {"v2c": v2c0[None, :].expand(B, -1).clone(),
                "llr": llr0[None, :].expand(B, -1).clone(),
                "dec": torch.zeros((B, self.tg.n), dtype=torch.bool, device=llr0.device)}

    def rows(self, v2c, j):
        """Bit j's (a (B,) index) slots and its checks' rows: (vedge, vchk,
        vmask, rows (B, dv, dc), others (B, dv, dc))."""
        dc = self.tg.dc
        vchk, vslot = self.var_chks[j], self.var_slot[j]
        row_ids = vchk[:, :, None] * dc + self.slots
        rows = v2c.gather(1, row_ids.reshape(len(j), -1)).reshape(vchk.shape + (dc,))
        others = self.chk_mask_pad[vchk] & (self.slots != vslot[:, :, None])
        return self.var_edges[j], vchk, self.var_mask[j], rows, others

    def min_and_negs(self, rows, others):
        """Per slot: the minimum |message| of the row's other slots (absent
        ones count 1e30) and how many of them are <= 0."""
        temp = torch.where(others, rows.abs(), self.big).min(dim=2).values
        negs = (others & (rows <= 0)).sum(dim=2)
        return temp, negs

    def update_bit(self, lanes, j, vedge, vmask, c2v):
        """Fold bit j's c2v into its posterior, decision and messages (a pad
        slot's message goes to the dump entry)."""
        llr_j, v2c_j = _fold_bit(self.init_llr[j], c2v, vmask)
        lanes["v2c"].scatter_(1, vedge, v2c_j)
        lanes["llr"].scatter_(1, j[:, None], llr_j[:, None])
        lanes["dec"].scatter_(1, j[:, None], (llr_j <= 0)[:, None])

    def parity(self, dec):
        """(B, m) parity of each check's hard decisions."""
        B, m, dc = dec.shape[0], self.tg.m, self.tg.dc
        pad = torch.zeros((B, 1), dtype=torch.bool, device=dec.device)
        hard = torch.cat([dec, pad], dim=1)[:, self.chk_bits]
        return hard.reshape(B, m, dc).sum(dim=2) % 2


def _run(g: _SerialGraph, lanes: dict, max_iter: int, begin, step, syndrome: str):
    """The iteration loop of a serial engine over the lanes' state
    ``lanes`` (per-lane tensors by name). Each iteration takes the lanes
    still running (a converged lane's state is its output, as the
    reference freezes it), runs ``begin(it, run)`` and then ``step(idx,
    run, ctx)`` for every bit position, writes the state back, and stops a
    lane whose decisions meet ``run[syndrome]``. Returns (conv, iters)."""
    B, dev = lanes["llr"].shape[0], lanes["llr"].device
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(conv.all()):
        it += 1
        act = torch.nonzero(~conv).squeeze(1)
        run = {k: v[act] for k, v in lanes.items()}
        ctx = begin(it, run)
        for idx in range(g.tg.n):
            step(idx, run, ctx)
        for k, v in run.items():
            lanes[k][act] = v
        iters[act] = it
        conv[act] = (g.parity(run["dec"]) == run[syndrome][:, : g.tg.m]).all(dim=1)
    return conv, iters


def bp_serial_reference(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    order: Optional[torch.Tensor],
    order_mode: int,
) -> BpResult:
    """Plain PyTorch serial-schedule BP (K6'), in ``init_llr``'s dtype.

    ``order`` is an (n,) int schedule for ORDER_FIXED, an (iterations, n)
    table for ORDER_TABLE (row ``it - 1`` in iteration ``it``), unused for
    ORDER_RELATIVE (``torch.argsort(-posterior, stable=True)`` per lane)."""
    dtype, dev = init_llr.dtype, syndromes.device
    B, n = syndromes.shape[0], tg.n
    g = _SerialGraph(tg, init_llr)
    lanes = g.lanes(B)
    lanes["syn"] = torch.cat(
        [syndromes.to(torch.int32), torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    half = torch.tensor(0.5, dtype=dtype, device=dev)

    def begin(it, run):
        alpha = _alpha(bp_method, ms_scaling_factor, it, dtype, dev)
        if order_mode == ORDER_RELATIVE:
            return alpha, torch.argsort(-run["llr"], dim=1, stable=True)
        row = order[it - 1] if order_mode == ORDER_TABLE else order
        return alpha, row.long()[None, :].expand(run["llr"].shape[0], n)

    def step(idx, run, ctx):
        alpha, sched = ctx
        j = sched[:, idx]
        vedge, vchk, vmask, rows, others = g.rows(run["v2c"], j)
        sgn = run["syn"].gather(1, vchk)
        if bp_method == MINIMUM_SUM:
            temp, negs = g.min_and_negs(rows, others)
            c2v = alpha * (1 - 2 * ((sgn + negs) % 2)).to(dtype) * temp
        else:
            p = torch.ones_like(rows[:, :, 0])
            for k in range(tg.dc):  # row order
                p = torch.where(others[:, :, k], p * torch.tanh(rows[:, :, k] * half), p)
            p = _clip(p)
            c2v = (1 - 2 * sgn).to(dtype) * torch.log((1 + p) / (1 - p))
        g.update_bit(run, j, vedge, vmask, c2v)

    conv, iters = _run(g, lanes, max_iter, begin, step, "syn")
    return BpResult(lanes["dec"].to(torch.uint8), lanes["llr"], conv, iters)


def bp_soft_info_reference(
    tg: TorchGraph,
    soft: torch.Tensor,
    init_llr: torch.Tensor,
    max_iter: int,
    ms_scaling_factor: float,
    cutoff: float,
):
    """Plain PyTorch soft-information BP (K7'): serial min-sum in index
    order over (B, m) soft syndromes already scaled by 2/sigma^2, in
    ``init_llr``'s dtype; the factor is always fixed. Returns (BpResult,
    the final (B, m) soft syndrome)."""
    dtype, dev = init_llr.dtype, soft.device
    B, m = soft.shape
    g = _SerialGraph(tg, init_llr)
    lanes = g.lanes(B)
    # a pad column m for the pad check (its values are never used)
    lanes["soft"] = torch.cat([soft.to(dtype), soft.new_zeros((B, 1), dtype=dtype)], dim=1)
    lanes["synd"] = (lanes["soft"] <= 0).to(torch.int32)
    alpha = _alpha(MINIMUM_SUM, ms_scaling_factor, 1, dtype, dev, dynamic=False)
    cut = torch.tensor(cutoff, dtype=dtype, device=dev)

    def step(idx, run, ctx):
        j = torch.full((run["llr"].shape[0],), idx, dtype=torch.long, device=dev)
        vedge, vchk, vmask, rows, others = g.rows(run["v2c"], j)
        temp, negs = g.min_and_negs(rows, others)
        sgn = negs % 2
        cur = run["v2c"].gather(1, vedge)
        ss, s = run["soft"].gather(1, vchk), run["synd"].gather(1, vchk)
        ss_mag = ss.abs()
        virt = (ss_mag < cut) & (ss_mag < temp)
        propagated = torch.where(virt, ss_mag, temp)
        agree = (sgn ^ (cur <= 0).to(torch.int32)) == s
        shrink = torch.minimum(cur.abs(), temp)
        ss_new = torch.where(
            virt & agree, (1 - 2 * s).to(dtype) * shrink, torch.where(virt & ~agree, -ss, ss)
        )
        s_new = torch.where(virt & ~agree, s ^ 1, s)
        c2v = alpha * (1 - 2 * (sgn ^ s_new)).to(dtype) * propagated
        run["soft"].scatter_(1, vchk, ss_new)
        run["synd"].scatter_(1, vchk, s_new)
        g.update_bit(run, j, vedge, vmask, c2v)

    conv, iters = _run(g, lanes, max_iter, lambda it, run: None, step, "synd")
    result = BpResult(lanes["dec"].to(torch.uint8), lanes["llr"], conv, iters)
    return result, lanes["soft"][:, :m]


def _check_min_sum(v2c3, mask3, syndrome, alpha, big):
    """Min-sum check update over the dc axis of (m, dc, B) messages:
    exclusive minimum with the first-occurrence argmin, sign parity of the
    other slots XOR the syndrome bit."""
    absv = torch.where(mask3, v2c3.abs(), big)
    neg = (mask3 & (v2c3 <= 0)).to(torch.int32)
    min1 = absv.min(dim=1).values
    amin = absv.argmin(dim=1)  # first occurrence
    slot = torch.arange(v2c3.shape[1], device=v2c3.device)[None, :, None]
    is_min = slot == amin[:, None, :]
    min2 = torch.where(is_min, big, absv).min(dim=1).values
    total_par = (syndrome[:, None, :] + neg.sum(dim=1, keepdim=True) + neg) % 2
    excl_min = torch.where(is_min, min2[:, None, :], min1[:, None, :])
    sign = (1 - 2 * total_par).to(v2c3.dtype)
    return torch.where(mask3, alpha * sign * excl_min, torch.zeros_like(v2c3))


def _check_product_sum(v2c3, mask3, syndrome):
    """Product-sum check update: exclusive prefix and suffix tanh products
    (float32: clipped away from +-1), signed by the syndrome bit."""
    half = torch.tensor(0.5, dtype=v2c3.dtype, device=v2c3.device)
    t = torch.where(mask3, torch.tanh(v2c3 * half), torch.ones_like(v2c3))
    ones = torch.ones_like(t[:, :1, :])
    prefix = torch.cat([ones, torch.cumprod(t, dim=1)[:, :-1, :]], dim=1)
    rev = torch.flip(t, dims=[1])
    suffix = torch.flip(torch.cat([ones, torch.cumprod(rev, dim=1)[:, :-1, :]], dim=1), dims=[1])
    p = _clip(prefix * suffix)
    mag = torch.log((1 + p) / (1 - p))
    sign = (1 - 2 * syndrome[:, None, :]).to(v2c3.dtype)
    return torch.where(mask3, sign * mag, torch.zeros_like(v2c3))


def bp_parallel_exact_reference(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
) -> BpResult:
    """Plain PyTorch fold-exact parallel BP (K8'), in ``init_llr``'s dtype:
    bit-to-check messages are stored, each bit folds its c2v in slot order
    and its extrinsic messages by partial plus reverse suffix; a lane's
    messages freeze when it converges."""
    dtype, dev = init_llr.dtype, syndromes.device
    m, n, dc, dv = tg.m, tg.n, tg.dc, tg.dv
    E, B = m * dc, syndromes.shape[0]
    chk_bits = tg.chk_bits.reshape(-1).long()
    var_edges = tg.var_edges.reshape(-1).long()
    var_mask = tg.var_mask
    mask3 = tg.chk_mask[:, :, None]
    syndrome = syndromes.t().to(torch.int32)  # (m, B)
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    zero_row = torch.zeros((1, B), dtype=dtype, device=dev)
    llr_col = init_llr[:, None].expand(n, B)
    v2c = torch.cat([init_llr, init_llr.new_zeros(1)])[chk_bits][:, None].expand(E, B).clone()
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    dec_out = torch.zeros((n, B), dtype=torch.bool, device=dev)
    llr_out = llr_col.clone()
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(conv.all()):
        it += 1
        alpha = _alpha(bp_method, ms_scaling_factor, it, dtype, dev)
        v2c3 = v2c.reshape(m, dc, B)
        if bp_method == MINIMUM_SUM:
            c2v = _check_min_sum(v2c3, mask3, syndrome, alpha, big)
        else:
            c2v = _check_product_sum(v2c3, mask3, syndrome)
        per_bit = torch.cat([c2v.reshape(E, B), zero_row])[var_edges].reshape(n, dv, B)
        acc = llr_col
        partials = []
        for k in range(dv):
            partials.append(acc)
            acc = torch.where(var_mask[:, k : k + 1], acc + per_bit[:, k], acc)
        hard = acc <= 0
        hard_pad = torch.cat([hard, torch.zeros((1, B), dtype=torch.bool, device=dev)])
        cand = hard_pad[chk_bits].reshape(m, dc, B).sum(dim=1) % 2
        conv_now = (cand == syndrome).all(dim=0)
        suf = torch.zeros((n, B), dtype=dtype, device=dev)
        slots = [None] * dv
        for k in reversed(range(dv)):
            slots[k] = partials[k] + suf
            suf = torch.where(var_mask[:, k : k + 1], suf + per_bit[:, k], suf)
        v2c_new = torch.zeros((E + 1, B), dtype=dtype, device=dev)
        v2c_new[var_edges] = torch.stack(slots, dim=1).reshape(n * dv, B)
        active = ~conv
        dec_out = torch.where(active[None, :], hard, dec_out)
        llr_out = torch.where(active[None, :], acc, llr_out)
        iters = torch.where(active, it, iters)
        v2c = torch.where((active & ~conv_now)[None, :], v2c_new[:E], v2c)
        conv = conv | conv_now
    return BpResult(dec_out.t().to(torch.uint8), llr_out.t(), conv, iters)


def _require(cond: bool, kernel: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}_cuda: {what}")


def state_variant(kernel: str, m: int, n: int, dc: int, dv: int, dtype,
                  relative: bool = False) -> str:
    """Where ``kernel`` ("bp_serial", "bp_soft_info" or
    "bp_parallel_exact") keeps a lane's state by default: ``"shared"``
    memory while it fits the per-lane budget of its kernel
    (``csrc/bp_fold.cu``; K8' ``csrc/bp_exact.cu``, whose lane is its
    messages and its decisions as bits), else a lane-major scratch in
    ``"device"`` memory (same kernel, still one warp per lane). Builds the
    kernels' library."""
    elem = torch.empty((), dtype=dtype).element_size()
    fits = _build.library().ldpc_bp_fold_shared_state(
        _ENGINE[kernel], m, n, dc, dv, elem, int(relative))
    return "shared" if fits else "device"


def _check_common(kernel, tg, lanes_in, init_llr, dtypes, graph_arrays):
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    returns the device."""
    dev = lanes_in.device
    _require(dev.type == "cuda", kernel, f"inputs must be on a CUDA device, not {dev}")
    for name, t in (("input", lanes_in), ("init_llr", init_llr), *graph_arrays):
        _require(t.device == dev, kernel, f"{name} is on {t.device}, the input on {dev}")
        _require(t.is_contiguous(), kernel, f"{name} must be contiguous")
    _require(init_llr.dtype in dtypes, kernel, f"init_llr must be one of {dtypes}")
    _require(init_llr.shape == (tg.n,), kernel, f"init_llr must have shape ({tg.n},)")
    _require(lanes_in.dim() == 2 and lanes_in.shape[1] == tg.m, kernel,
             f"input must have shape (B, {tg.m}), not {tuple(lanes_in.shape)}")
    for name, t in graph_arrays:
        _require(t.dtype == torch.int32, kernel, f"{name} must be int32")
    return dev


def _pick_state(kernel, tg, dtype, state, relative=False):
    state = state_variant(kernel, tg.m, tg.n, tg.dc, tg.dv, dtype, relative) if state is None \
        else state
    _require(state in ("shared", "device"), kernel, "state must be 'shared' or 'device'")
    return state


def _outputs(B, n, dtype, dev):
    return (torch.empty((B, n), dtype=dtype, device=dev),
            torch.empty((B, n), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev))


def _count(kernel, state):
    LAUNCHES[kernel] += 1
    STATE_LAUNCHES[kernel][state] += 1


def _check_levels(kernel, levels, rows_ok, n, dev):
    """The levels' device, type, shapes and contiguity; ``rows_ok(R)``
    says whether R rows serve the call."""
    for name, t, width in (("levels.bits", levels.bits, n), ("levels.ptr", levels.ptr, n + 1)):
        _require(t.device == dev, kernel, f"{name} is on {t.device}, the input on {dev}")
        _require(t.dtype == torch.int32 and t.is_contiguous(), kernel,
                 f"{name} must be contiguous int32")
        _require(t.dim() == 2 and t.shape[1] == width and rows_ok(t.shape[0]), kernel,
                 f"{name} has shape {tuple(t.shape)}")
    _require(levels.bits.shape[0] == levels.ptr.shape[0], kernel,
             "levels.bits and levels.ptr differ in rows")


def _check_profile(kernel, profile, B, dev):
    """An optional (B, 5) int64 buffer for the kernel's counters; its
    pointer or 0."""
    if profile is None:
        return 0
    _require(profile.device == dev and profile.dtype == torch.int64
             and profile.shape == (B, 5) and profile.is_contiguous(), kernel,
             f"profile must be a contiguous ({B}, 5) int64 tensor on {dev}")
    return profile.data_ptr()


def bp_serial_cuda(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    order: Optional[torch.Tensor],
    order_mode: int,
    state: Optional[str] = None,
    levels: Optional[Levels] = None,
    profile: Optional[torch.Tensor] = None,
) -> BpResult:
    """Launch K6' on CUDA tensors: one warp per lane, a level of the
    order a step. ``order`` as for :func:`bp_serial_reference` (int32,
    contiguous; the random-serial table is ``max_iter * n * 4`` bytes).
    ``levels``: the order's :func:`level_schedule` (one row, or a row per
    table row), computed here from a host copy of ``order`` when None;
    serial-relative builds each lane's levels in the kernel. ``state``
    forces where a lane's state lives (tests only); by default
    :func:`state_variant` chooses. ``profile``: an optional (B, 5) int64
    tensor that receives, per lane, the clock cycles spent sorting, in
    the levels pass and bucketing, and sweeping, then the levels swept in
    all and the most in one sweep."""
    kernel = "bp_serial"
    m, n, dc, dv = tg.m, tg.n, tg.dc, tg.dv
    relative = order_mode == ORDER_RELATIVE
    arrays = [("chk_bits", tg.chk_bits), ("var_edges", tg.var_edges),
              ("var_chks", tg.var_chks)]
    if not relative:
        arrays.append(("order", order))
    dev = _check_common(kernel, tg, syndromes, init_llr, _FLOATS, arrays)
    _require(syndromes.dtype == torch.uint8, kernel, "syndromes must be uint8")
    _require(order_mode in (ORDER_FIXED, ORDER_TABLE, ORDER_RELATIVE), kernel,
             f"unknown order_mode {order_mode}")
    if order_mode == ORDER_FIXED:
        _require(order.shape == (n,), kernel, f"order must have shape ({n},)")
    if order_mode == ORDER_TABLE:
        _require(order.dim() == 2 and order.shape[1] == n and order.shape[0] >= max_iter,
                 kernel, f"order must have shape (>= {max_iter}, {n})")
    _require(max_iter >= 0, kernel, "max_iter must be >= 0")
    B = syndromes.shape[0]
    prof = _check_profile(kernel, profile, B, dev)
    if not relative:
        levels = level_schedule(tg, order) if levels is None else levels
        rows_ok = (lambda r: r == 1) if order_mode == ORDER_FIXED else (lambda r: r >= max_iter)
        _check_levels(kernel, levels, rows_ok, n, dev)
    dtype = init_llr.dtype
    state = _pick_state(kernel, tg, dtype, state, relative)
    device_state = state == "device"
    msg = torch.empty((B if device_state else 0, m * dc), dtype=dtype, device=dev)
    post, dec, conv, iters = _outputs(B, n, dtype, dev)
    if B:
        lib = _build.library()
        rel_bytes = lib.ldpc_bp_serial_relative_bytes(m, n)
        rel = torch.empty((B if device_state and relative else 0, rel_bytes),
                          dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            rc = lib.ldpc_bp_serial(
                syndromes.data_ptr(), init_llr.data_ptr(), tg.chk_bits.data_ptr(),
                tg.var_edges.data_ptr(), tg.var_chks.data_ptr(),
                0 if relative else levels.bits.data_ptr(),
                0 if relative else levels.ptr.data_ptr(),
                m, n, dc, dv, B, max_iter, order_mode, int(bp_method == MINIMUM_SUM),
                int(dtype == torch.float64), float(ms_scaling_factor), int(not device_state),
                msg.data_ptr(), rel.data_ptr(), post.data_ptr(), dec.data_ptr(),
                conv.data_ptr(), iters.data_ptr(), prof,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, kernel)
        _count(kernel, state)
    return BpResult(decoding=dec, llr_posterior=post, converged=conv, iterations=iters)


def bp_soft_info_cuda(
    tg: TorchGraph,
    soft: torch.Tensor,
    init_llr: torch.Tensor,
    max_iter: int,
    ms_scaling_factor: float,
    cutoff: float,
    state: Optional[str] = None,
    levels: Optional[Levels] = None,
    profile: Optional[torch.Tensor] = None,
):
    """Launch K7' on CUDA tensors: ``soft`` (B, m) scaled soft syndromes in
    ``init_llr``'s dtype; the sweep takes the levels of index order
    (``levels``, one row; computed here when None). ``profile`` as for
    :func:`bp_serial_cuda`. Returns (BpResult, the final soft syndrome)."""
    kernel = "bp_soft_info"
    m, n, dc, dv = tg.m, tg.n, tg.dc, tg.dv
    dev = _check_common(kernel, tg, soft, init_llr, _FLOATS,
                        [("chk_bits", tg.chk_bits), ("var_edges", tg.var_edges),
                         ("var_chks", tg.var_chks)])
    dtype = init_llr.dtype
    _require(soft.dtype == dtype, kernel, "soft must have init_llr's dtype")
    _require(max_iter >= 0, kernel, "max_iter must be >= 0")
    B = soft.shape[0]
    prof = _check_profile(kernel, profile, B, dev)
    if levels is None:
        levels = level_schedule(tg, torch.arange(n, dtype=torch.int32, device=dev))
    _check_levels(kernel, levels, lambda r: r == 1, n, dev)
    state = _pick_state(kernel, tg, dtype, state)
    device_state = state == "device"
    msg = torch.empty((B if device_state else 0, m * dc), dtype=dtype, device=dev)
    synd = torch.empty((B if device_state else 0, m), dtype=torch.uint8, device=dev)
    soft_out = torch.empty((B, m), dtype=dtype, device=dev)
    post, dec, conv, iters = _outputs(B, n, dtype, dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_bp_soft_info(
                soft.data_ptr(), init_llr.data_ptr(), tg.chk_bits.data_ptr(),
                tg.var_edges.data_ptr(), tg.var_chks.data_ptr(), levels.bits.data_ptr(),
                levels.ptr.data_ptr(), m, n, dc, dv, B, max_iter,
                int(dtype == torch.float64), float(ms_scaling_factor), float(cutoff),
                int(not device_state), msg.data_ptr(), synd.data_ptr(), post.data_ptr(),
                dec.data_ptr(), soft_out.data_ptr(), conv.data_ptr(), iters.data_ptr(), prof,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, kernel)
        _count(kernel, state)
    return BpResult(decoding=dec, llr_posterior=post, converged=conv, iterations=iters), soft_out


def exact_resident_lanes(tg: TorchGraph, bp_method: int, state: str = "shared") -> int:
    """K8' lanes resident on one SM of the current card for ``tg``: the
    occupancy its registers and shared memory allow. Builds the library."""
    got = _build.library().ldpc_bp_exact_resident_lanes(tg.m, tg.n, tg.dc, tg.dv,
                                                        int(bp_method == MINIMUM_SUM),
                                                        int(state == "shared"))
    _require(got >= 0, "bp_parallel_exact", f"no occupancy in the {state} state")
    return got


def bp_parallel_exact_cuda(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    state: Optional[str] = None,
    profile: Optional[torch.Tensor] = None,
) -> BpResult:
    """Launch K8' on CUDA tensors (float64): one warp per lane, eight lanes
    a block, each warp claiming lanes until the batch is done, on K1''s
    slot-major graph views. ``state`` forces where a lane's messages live
    (tests). ``profile``: an optional (B, 5) int64 tensor that receives,
    per lane, the clock cycles of its prologue, check passes, bit passes,
    syndrome tests and epilogue."""
    kernel = "bp_parallel_exact"
    m, n, dc, dv = tg.m, tg.n, tg.dc, tg.dv
    dev = _check_common(kernel, tg, syndromes, init_llr, (torch.float64,),
                        [("chk_bits_t", tg.chk_bits_t), ("var_edges_t", tg.var_edges_t)])
    _require(syndromes.dtype == torch.uint8, kernel, "syndromes must be uint8")
    _require(bp_method == MINIMUM_SUM or dc <= _MAX_DC, kernel,
             f"product-sum row degree {dc} exceeds {_MAX_DC}")
    _require(max_iter >= 0, kernel, "max_iter must be >= 0")
    state = _pick_state(kernel, tg, torch.float64, state)
    B = syndromes.shape[0]
    prof = _check_profile(kernel, profile, B, dev)
    device_state = state == "device"
    msg = torch.empty((B if device_state else 0, m * dc), dtype=torch.float64, device=dev)
    post, dec, conv, iters = _outputs(B, n, torch.float64, dev)
    if B:
        lib = _build.library()
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the lanes' claim counter
        with torch.cuda.device(dev):
            rc = lib.ldpc_bp_parallel_exact(
                syndromes.data_ptr(), init_llr.data_ptr(), tg.chk_bits_t.data_ptr(),
                tg.var_edges_t.data_ptr(), m, n, dc, dv, B, max_iter,
                int(bp_method == MINIMUM_SUM), float(ms_scaling_factor), int(not device_state),
                msg.data_ptr(), post.data_ptr(), dec.data_ptr(), conv.data_ptr(),
                iters.data_ptr(), nxt.data_ptr(), prof, torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, kernel)
        _count(kernel, state)
    return BpResult(decoding=dec, llr_posterior=post, converged=conv, iterations=iters)


def _device_kind(t: torch.Tensor, kernel: str) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return kind


def bp_serial(tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor, order,
              order_mode, levels: Optional[Levels] = None) -> BpResult:
    """K6' on a CUDA tensor (on ``levels`` when given), its plain version on
    a CPU tensor."""
    args = (tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor, order, order_mode)
    if _device_kind(syndromes, "bp_serial") == "cpu":
        return bp_serial_reference(*args)
    return bp_serial_cuda(*args, levels=levels)


def bp_soft_info(tg, soft, init_llr, max_iter, ms_scaling_factor, cutoff,
                 levels: Optional[Levels] = None):
    """K7' on a CUDA tensor (on ``levels`` when given), its plain version on
    a CPU tensor."""
    args = (tg, soft, init_llr, max_iter, ms_scaling_factor, cutoff)
    if _device_kind(soft, "bp_soft_info") == "cpu":
        return bp_soft_info_reference(*args)
    return bp_soft_info_cuda(*args, levels=levels)


def bp_parallel_exact(tg, syndromes, init_llr, bp_method, max_iter,
                      ms_scaling_factor) -> BpResult:
    """K8' on a CUDA tensor, its plain version on a CPU tensor."""
    args = (tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor)
    if _device_kind(syndromes, "bp_parallel_exact") == "cpu":
        return bp_parallel_exact_reference(*args)
    return bp_parallel_exact_cuda(*args)
