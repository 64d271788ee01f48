"""Kernels K2'-K5': batched GF(2) elimination (counterparts of ``ops/gf2_pallas.py``).

Every kernel here solves H x = s for a batch of lanes by swap-free
Gauss-Jordan over the packed [H | s], taking each lane's columns in its own
order (``order`` (B, n), the caller's stable argsort of the LLRs); the pivot
is the first unused row holding a 1. They are one source,
``csrc/gf2_elim.cu``, and differ in when a lane stops and in what they
return:

- ``osd0`` (K2'): OSD-0. Stops at the syndrome fast exit of
  ``ldpc_tpu/ops/gf2.py::batched_rref(fast_exit=True)`` or at ``rank``
  pivots; returns ``(x0 (B, n) uint8 in original column coordinates,
  valid (B,) bool)``.
- ``rref_export`` (K3'): runs to ``rank`` pivots and exports the reduced
  matrix.
- ``masked_solve`` (K4'): lane l takes only its first ``count[l]``
  columns; returns ``(x0, bad_row (B, m) bool)``, ``bad_row`` marking the
  unused rows that still hold a syndrome 1.
- ``masked_export`` (K5'): K4's elimination with K3's export.

Each has three variants (:func:`elim_variant`): ``"warp"``, one warp per
lane, the default while a lane fits the kernel's budget; ``"block"``, one
block per lane with the lane's matrix in shared memory, for larger codes
(and for K5' from surface d=15 on); and ``"device"``, the block body with
the matrix in device memory, for codes above a block's shared memory
(toric d=31 and up). In the device variant K3' and K5' eliminate in place
in their own output; K2' and K4' take a scratch that the wrapper allocates,
at most :data:`SCRATCH_BYTES`, and run the batch in lane chunks, one launch
a chunk. K4's warp variant works on the lane's own columns only
(:func:`masked_solve_compact_reference` is its plain model), and K2's on
the lane's columns 32 at a time, replaying the pivots it has recorded on
each further word (:func:`osd0_compact_reference`). The wrappers'
``variant`` keyword forces one (tests and measurement only).

The export is ``(M (B, m, Wp) int32 words of [R | T s] in original column
coordinates, col_of_row (B, m) int32 pivot column of each row (n if the row
is unused), used (B, m) bool)``; ``Wp = ceil((n+1)/32)`` and the reduced
syndrome is bit ``n`` of each row.

For each kernel, ``*_reference`` is the plain PyTorch version, ``*_cuda``
launches the kernel on CUDA tensors and counts every launch under
``launch.<kernel>`` and ``launch.<kernel>.<variant>`` (the recorder's table:
``ldpc_tpu_torch.utils.profiling``), and the bare name picks by the
tensors' device: the CPU runs the plain version, a CUDA device runs the
kernel, anything else raises.
"""

from typing import Optional, Tuple

import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.pcm import TorchGraph
from ldpc_tpu_torch.utils import profiling

VARIANTS = ("warp", "block", "device")  # in the order of the library's variant ids

_MAX_ROWS = 32 * 1024  # 1024 threads owning at most 32 rows each
# the most scratch a K2' or K4' launch of the device variant is given; larger
# batches run in chunks of lanes
SCRATCH_BYTES = 256 * 2**20

Export = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _eliminate(tg, syndromes, order, limit, rank, fast_exit):
    """Plain batched Gauss-Jordan shared by the reference versions.

    Lane b takes at most its first ``limit[b]`` columns of ``order``, stops
    once it has ``rank`` pivots and, with ``fast_exit``, once no unused row
    holds a syndrome 1. Returns ``(M (B, m, Wp) int64 words, each holding
    32 bits as a non-negative number; used (B, m) bool; col_of_row (B, m)
    int64, 0 on unused rows)``.
    """
    m, n = tg.m, tg.n
    B = syndromes.shape[0]
    dev = syndromes.device
    ws, bs = n // 32, n % 32  # syndrome column's word and bit
    order = order.long()
    M = (tg.packed.to(torch.int64) & 0xFFFFFFFF).unsqueeze(0).repeat(B, 1, 1)
    M[:, :, ws] |= syndromes.to(torch.int64) << bs
    rows = torch.arange(m, device=dev)
    lanes = torch.arange(B, device=dev)
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    col_of_row = torch.zeros((B, m), dtype=torch.int64, device=dev)
    used_cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = min(n, int(limit.max())) if B else 0
    for j in range(steps):
        # finished lanes are frozen, as the kernels stop them
        active = (limit > j) & (used_cnt < rank)
        if fast_exit:
            sbit = ((M[:, :, ws] >> bs) & 1).bool()
            active &= (sbit & ~used).any(dim=1)
        if not bool(active.any()):
            break
        c = order[:, j]
        w, bit = c >> 5, c & 31
        colw = torch.gather(M, 2, w.view(B, 1, 1).expand(B, m, 1)).squeeze(2)
        col = ((colw >> bit[:, None]) & 1).bool() & active[:, None]
        cand = col & ~used
        has = cand.any(dim=1)
        piv = cand.to(torch.uint8).argmax(dim=1)  # first unused row with a 1
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        piv_vec = M[lanes, piv]  # (B, Wp)
        elim = col & ~is_piv & has[:, None]
        M = torch.where(elim[:, :, None], M ^ piv_vec[:, None, :], M)
        used = used | is_piv
        col_of_row = torch.where(is_piv, c[:, None], col_of_row)
        used_cnt = used_cnt + has.long()
    return M, used, col_of_row


def _syndrome_bits(tg: TorchGraph, M: torch.Tensor) -> torch.Tensor:
    """The reduced syndrome, bit ``n`` of every row: (B, m) bool."""
    return ((M[:, :, tg.n // 32] >> (tg.n % 32)) & 1).bool()


def _readout(tg, M, used, col_of_row) -> torch.Tensor:
    """x0[col_of_row[r]] = syndrome bit of row r, for used rows."""
    B = M.shape[0]
    x0 = torch.zeros((B, tg.n + 1), dtype=torch.uint8, device=M.device)
    target = torch.where(used, col_of_row, tg.n)  # unused rows -> dummy column
    x0.scatter_(1, target, (_syndrome_bits(tg, M) & used).to(torch.uint8))
    return x0[:, : tg.n].contiguous()


def _export(tg, M, used, col_of_row) -> Export:
    words = torch.where(M >= 2**31, M - 2**32, M).to(torch.int32)  # uint32 bits
    colrow = torch.where(used, col_of_row, tg.n).to(torch.int32)
    return words.contiguous(), colrow.contiguous(), used


def _all_columns(syndromes: torch.Tensor, n: int) -> torch.Tensor:
    return torch.full((syndromes.shape[0],), n, dtype=torch.int64, device=syndromes.device)


def osd0_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch OSD-0 on (B, m) uint8 syndromes."""
    limit = _all_columns(syndromes, tg.n)
    M, used, col_of_row = _eliminate(tg, syndromes, order, limit, rank, True)
    valid = ~(_syndrome_bits(tg, M) & ~used).any(dim=1)
    return _readout(tg, M, used, col_of_row), valid


def rref_export_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Export:
    """Plain PyTorch K3': full elimination to ``rank`` pivots, exported."""
    limit = _all_columns(syndromes, tg.n)
    return _export(tg, *_eliminate(tg, syndromes, order, limit, rank, False))


def masked_solve_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4': each lane eliminates its first ``count`` columns."""
    M, used, col_of_row = _eliminate(
        tg, syndromes, order, count.long(), tg.m + 1, False
    )
    bad_row = _syndrome_bits(tg, M) & ~used
    return _readout(tg, M, used, col_of_row), bad_row


def masked_export_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Export:
    """Plain PyTorch K5': K4's masked elimination, exported."""
    return _export(
        tg, *_eliminate(tg, syndromes, order, count.long(), tg.m + 1, False)
    )


def masked_solve_compact_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch model of K4's warp variant, equal to
    :func:`masked_solve_reference` bit for bit; no decoder calls it.

    Lane b's working matrix holds only its own columns: bit j of row r is
    ``H[r, order[b, j]]`` for ``j < count[b]``, built from ``var_chks``, and
    the syndrome sits at bit ``count[b]``, 32 bits to an int64 word. Every
    pivot and XOR on the bits K4' reads out depends on these columns only.
    After the elimination the pivot columns map back through ``order``.
    """
    m, n = tg.m, tg.n
    B = syndromes.shape[0]
    dev = syndromes.device
    count = count.long().clamp(0, n)
    W = int(count.max()) if B else 0
    Wc = (W + 32) // 32  # words of W columns and the syndrome
    lanes = torch.arange(B, device=dev)
    rows = torch.arange(m, device=dev)
    cols = torch.arange(W, device=dev)
    order = order.long()
    # bits (B, m + 1, 32 Wc): row m takes the pad slots of var_chks
    bits = torch.zeros((B, m + 1, 32 * Wc), dtype=torch.int64, device=dev)
    chks = tg.var_chks.long()[order[:, :W]]  # (B, W, dv)
    inside = (cols[None, :] < count[:, None])[:, :, None].expand_as(chks)
    bits[
        lanes[:, None, None].expand_as(chks)[inside],
        chks[inside],
        cols[None, :, None].expand_as(chks)[inside],
    ] = 1
    bits[lanes[:, None], rows[None, :], count[:, None]] = syndromes.long()
    shifts = torch.arange(32, device=dev)
    M = (bits[:, :m].view(B, m, Wc, 32) << shifts).sum(dim=3)  # (B, m, Wc)
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    pivot_col = torch.zeros((B, m), dtype=torch.int64, device=dev)
    for j in range(W):
        col = ((M[:, :, j >> 5] >> (j & 31)) & 1).bool() & (count > j)[:, None]
        cand = col & ~used
        has = cand.any(dim=1)
        piv = cand.to(torch.uint8).argmax(dim=1)  # first unused row with a 1
        is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
        elim = col & ~is_piv & has[:, None]
        M = torch.where(elim[:, :, None], M ^ M[lanes, piv][:, None, :], M)
        used = used | is_piv
        pivot_col = torch.where(is_piv, j, pivot_col)
    sword = torch.gather(M, 2, (count >> 5).view(B, 1, 1).expand(B, m, 1)).squeeze(2)
    sbits = ((sword >> (count & 31)[:, None]) & 1).bool()
    x0 = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    target = torch.where(used, torch.gather(order, 1, pivot_col), n)
    x0.scatter_(1, target, (sbits & used).to(torch.uint8))
    return x0[:, :n].contiguous(), sbits & ~used


def _osd0_history_pivots(m: int, Wp: int) -> int:
    """Pivots whose record fits a lane of K2's warp variant
    (``osd0_history_pivots`` in ``csrc/gf2_elim.cu``): 33 words a pivot in
    the lane's 32 R (S - 1) idle words, R = ceil(m / 32), S = Wp | 1."""
    return (32 * -(-m // 32) * ((Wp | 1) - 1)) // 33


def osd0_compact_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch model of K2's warp variant, equal to
    :func:`osd0_reference` bit for bit; no decoder calls it.

    The syndrome is kept beside the matrix, one bit a row: a pivot row whose
    bit is 1 toggles the bits of the rows it is XORed into. A lane walks its
    columns 32 at a time, one word a row, bit j of row r being
    ``H[r, order[b, 32 w + j]]``, built from ``var_chks``. Every pivot is
    recorded (the pivot row and the rows that took its XOR), and a further
    word first takes the recorded pivots' XORs in their order, which brings
    its columns to where the elimination stands. A lane with more pivots
    than the record holds starts again on the full-width matrix, which takes
    the same pivots and goes on.
    """
    m, n = tg.m, tg.n
    B = syndromes.shape[0]
    dev = syndromes.device
    room = _osd0_history_pivots(m, tg.packed.shape[1])
    lanes = torch.arange(B, device=dev)
    rows = torch.arange(m, device=dev)
    shifts = torch.arange(32, device=dev)
    order = order.long()
    var_chks = tg.var_chks.long()
    synd = syndromes.bool().clone()
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    pivot_col = torch.zeros((B, m), dtype=torch.int64, device=dev)
    used_cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    active = synd.any(dim=1) & (rank > 0)
    again = torch.zeros(B, dtype=torch.bool, device=dev)  # lanes that start again
    record = []  # (pivot row (B,), rows that took its XOR (B, m)) of every pivot step
    for j0 in range(0, n, 32):
        if not bool(active.any()):
            break
        cols = min(32, n - j0)
        # bits (B, m + 1, 32): row m takes the pad slots of var_chks
        bits = torch.zeros((B, m + 1, 32), dtype=torch.int64, device=dev)
        chks = var_chks[order[:, j0 : j0 + cols]]  # (B, cols, dv)
        bits[
            lanes[:, None, None].expand_as(chks),
            chks,
            shifts[None, :cols, None].expand_as(chks),
        ] = 1
        word = (bits[:, :m] << shifts).sum(dim=2)  # (B, m)
        for piv, elim in record:
            word = torch.where(elim, word ^ word[lanes, piv][:, None], word)
        for j in range(cols):
            col = ((word >> j) & 1).bool() & active[:, None]
            cand = col & ~used
            has = cand.any(dim=1)
            full = has & (used_cnt == room)  # no room for this pivot's record
            again |= full
            active = active & ~full
            has = has & ~full
            if not bool(has.any()):
                continue
            piv = cand.to(torch.uint8).argmax(dim=1)  # first unused row with a 1
            is_piv = (rows[None, :] == piv[:, None]) & has[:, None]
            elim = col & ~is_piv & has[:, None]
            word = torch.where(elim, word ^ word[lanes, piv][:, None], word)
            synd = synd ^ (elim & synd[lanes, piv][:, None])
            used = used | is_piv
            pivot_col = torch.where(is_piv, order[:, j0 + j][:, None], pivot_col)
            used_cnt = used_cnt + has.long()
            record.append((piv, elim))
            active = active & (synd & ~used).any(dim=1) & (used_cnt < rank)
    x0 = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    x0.scatter_(1, torch.where(used, pivot_col, n), (synd & used).to(torch.uint8))
    x0 = x0[:, :n].contiguous()
    valid = ~(synd & ~used).any(dim=1)
    if bool(again.any()):
        x0[again], valid[again] = osd0_reference(
            tg, syndromes[again], order[again].to(torch.int32), rank
        )
    return x0, valid


def columns_walked(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor,
    limit: torch.Tensor, rank: int, fast_exit: bool,
) -> torch.Tensor:
    """Columns of its order each lane's elimination walks before it stops,
    (B,) int64, counted by the plain elimination: up to its last pivot (a
    lane that stops at ``rank`` pivots or at the fast exit stops right after
    a pivot), or all ``limit`` columns of a lane that neither ends. The
    arguments are those of :func:`pivots_taken`."""
    n = tg.n
    limit = limit.long().clamp(0, n)
    M, used, col_of_row = _eliminate(tg, syndromes, order, limit, rank, fast_exit)
    place = torch.empty_like(order, dtype=torch.long).scatter_(
        1, order.long(), torch.arange(n, device=order.device).expand(order.shape))
    last = torch.where(used, torch.gather(place, 1, col_of_row), -1).max(dim=1).values + 1
    ended = used.sum(dim=1) >= rank
    if fast_exit:
        ended |= ~(_syndrome_bits(tg, M) & ~used).any(dim=1)
    return torch.where(ended, last, limit)


def pivots_taken(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor,
    limit: torch.Tensor, rank: int, fast_exit: bool,
) -> torch.Tensor:
    """Pivots each lane's elimination takes, (B,) int64, counted by the
    plain elimination: the data-dependent work of a kernel's bound. ``limit``
    is each lane's column count (``n`` for K2' and K3', ``count`` for K4'
    and K5'); ``rank`` and ``fast_exit`` are as the kernel takes them."""
    _, used, _ = _eliminate(tg, syndromes, order, limit.long(), rank, fast_exit)
    return used.sum(dim=1)


def _check(
    kernel: str,
    tg: TorchGraph,
    syndromes: torch.Tensor,
    order: torch.Tensor,
    count: Optional[torch.Tensor] = None,
    var_chks: bool = False,
) -> int:
    """Validate a launch's inputs (``var_chks``: the warp variants of K2'
    and K4' read the graph's ``var_chks``); return the batch size."""

    def require(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"{kernel}_cuda: {what}")

    dev = syndromes.device
    m, n = tg.m, tg.n
    Wp = tg.packed.shape[1]
    require(dev.type == "cuda", f"syndromes must be on a CUDA device, not {dev}")
    named = [("order", order), ("packed", tg.packed)]
    if count is not None:
        named.append(("count", count))
    if var_chks:
        named.append(("var_chks", tg.var_chks))
    for name, t in named:
        require(t.device == dev, f"{name} is on {t.device}, syndromes on {dev}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(syndromes.is_contiguous(), "syndromes must be contiguous")
    require(syndromes.dtype == torch.uint8, "syndromes must be uint8")
    require(
        syndromes.dim() == 2 and syndromes.shape[1] == m,
        f"syndromes must have shape (B, {m}), not {tuple(syndromes.shape)}",
    )
    B = syndromes.shape[0]
    require(order.dtype == torch.int32, "order must be int32")
    require(order.shape == (B, n), f"order must have shape ({B}, {n})")
    if count is not None:
        require(count.dtype == torch.int32, "count must be int32")
        require(count.shape == (B,), f"count must have shape ({B},)")
    require(tg.packed.dtype == torch.int32, "packed H must be int32 words")
    require(Wp * 32 >= n + 1, "packed H has no room for the syndrome column")
    if var_chks:
        require(tg.var_chks.dtype == torch.int32, "var_chks must be int32")
        require(tg.var_chks.shape == (n, tg.dv), f"var_chks must have shape ({n}, {tg.dv})")
    return B


def _check_block(kernel: str, tg: TorchGraph) -> None:
    """The one limit of the block and device variants: a block's 1,024
    threads own at most 32 rows each (one 32-bit mask of used rows). The
    size of the working matrix is no limit: above a block's shared memory it
    lives in device memory."""
    if tg.m > _MAX_ROWS:
        raise ValueError(
            f"{kernel}_cuda: {tg.m} checks exceed the {_MAX_ROWS} a block's "
            f"threads can own (32 rows each)"
        )


_KERNEL_IDS = {"rref_export": 0, "masked_solve": 1, "masked_export": 2, "osd0": 3}


def elim_variant(kernel: str, m: int, n: int) -> str:
    """Where ``kernel`` (``"osd0"``, ``"rref_export"``, ``"masked_solve"``
    or ``"masked_export"``) runs an (m, n) code by default: ``"warp"`` (one
    warp per lane, several lanes a block) while a lane fits the kernel's
    per-lane budget, else ``"block"`` (one block per lane) while the lane's
    matrix fits a block's shared memory, else ``"device"`` (the block body
    on a matrix in device memory). The budgets and the layout live in
    ``csrc/gf2_elim.cu``, so this builds the kernels' library."""
    return VARIANTS[_build.library().ldpc_elim_variant(_KERNEL_IDS[kernel], m, n)]


def _variant(kernel: str, tg: TorchGraph, variant: Optional[str]) -> str:
    """The variant a launch takes; ``variant`` forces one (tests and
    measurement only)."""
    variant = elim_variant(kernel, tg.m, tg.n) if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"{kernel}_cuda: variant must be one of {VARIANTS}, not {variant!r}")
    if variant != "warp":
        _check_block(kernel, tg)
    return variant


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _empty_export(tg, B, dev) -> Export:
    return (
        torch.empty((B, tg.m, tg.packed.shape[1]), dtype=torch.int32, device=dev),
        torch.empty((B, tg.m), dtype=torch.int32, device=dev),
        torch.empty((B, tg.m), dtype=torch.bool, device=dev),
    )


def _chunks(tg: TorchGraph, B: int, variant: str, dev):
    """How a K2' or K4' batch is launched: ``(scratch, [(start, stop), ...])``.
    The warp and block variants take the batch in one launch and no scratch;
    the device variant takes a lane's matrix and pivot columns, ``m * Wp + m``
    words, from a scratch of at most SCRATCH_BYTES, in chunks of lanes."""
    if B == 0:
        return None, []
    if variant != "device":
        return None, [(0, B)]
    lane_words = tg.m * tg.packed.shape[1] + tg.m
    chunk = min(B, max(1, SCRATCH_BYTES // (4 * lane_words)))
    scratch = torch.empty((chunk, lane_words), dtype=torch.int32, device=dev)
    return scratch, [(a, min(a + chunk, B)) for a in range(0, B, chunk)]


def _count(kernel: str, variant: str) -> None:
    profiling.count("launch." + kernel)
    profiling.count(f"launch.{kernel}.{variant}")


def osd0_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int,
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2' (``csrc/gf2_elim.cu``) on CUDA tensors, in the variant of
    :func:`elim_variant` unless ``variant`` forces one. The warp variant
    builds each lane's columns, 32 at a time, from ``tg.var_chks``."""
    B = _check("osd0", tg, syndromes, order, var_chks=True)
    variant = _variant("osd0", tg, variant)
    dev = syndromes.device
    x0 = torch.empty((B, tg.n), dtype=torch.uint8, device=dev)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    scratch, chunks = _chunks(tg, B, variant, dev)
    lib = _build.library() if chunks else None
    for a, b in chunks:
        with torch.cuda.device(dev):
            rc = lib.ldpc_osd0(
                syndromes[a:b].data_ptr(), order[a:b].data_ptr(), tg.packed.data_ptr(),
                tg.var_chks.data_ptr(), tg.m, tg.n, tg.packed.shape[1], tg.dv,
                int(rank), b - a, VARIANTS.index(variant), x0[a:b].data_ptr(),
                valid[a:b].data_ptr(), None if scratch is None else scratch.data_ptr(),
                _stream(dev),
            )
        _build.check(lib, rc, "osd0")
        _count("osd0", variant)
    return x0, valid


def rref_export_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int,
    variant: Optional[str] = None,
) -> Export:
    """Launch K3' (``csrc/gf2_elim.cu``) on CUDA tensors, in the variant of
    :func:`elim_variant` unless ``variant`` forces one."""
    B = _check("rref_export", tg, syndromes, order)
    variant = _variant("rref_export", tg, variant)
    dev = syndromes.device
    out = _empty_export(tg, B, dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_rref_export(
                syndromes.data_ptr(), order.data_ptr(), tg.packed.data_ptr(),
                tg.m, tg.n, tg.packed.shape[1], int(rank), B, VARIANTS.index(variant),
                *(t.data_ptr() for t in out), _stream(dev),
            )
        _build.check(lib, rc, "rref_export")
        _count("rref_export", variant)
    return out


def masked_solve_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor,
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4' (``csrc/gf2_elim.cu``) on CUDA tensors, in the variant of
    :func:`elim_variant` unless ``variant`` forces one. The warp
    variant builds each lane's own columns from ``tg.var_chks``; the
    others read the packed H."""
    B = _check("masked_solve", tg, syndromes, order, count, var_chks=True)
    variant = _variant("masked_solve", tg, variant)
    dev = syndromes.device
    x0 = torch.empty((B, tg.n), dtype=torch.uint8, device=dev)
    bad_row = torch.empty((B, tg.m), dtype=torch.bool, device=dev)
    scratch, chunks = _chunks(tg, B, variant, dev)
    lib = _build.library() if chunks else None
    for a, b in chunks:
        with torch.cuda.device(dev):
            rc = lib.ldpc_masked_solve(
                syndromes[a:b].data_ptr(), order[a:b].data_ptr(), count[a:b].data_ptr(),
                tg.packed.data_ptr(), tg.var_chks.data_ptr(), tg.m, tg.n,
                tg.packed.shape[1], tg.dv, b - a, VARIANTS.index(variant),
                x0[a:b].data_ptr(), bad_row[a:b].data_ptr(),
                None if scratch is None else scratch.data_ptr(), _stream(dev),
            )
        _build.check(lib, rc, "masked_solve")
        _count("masked_solve", variant)
    return x0, bad_row


def masked_export_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor,
    variant: Optional[str] = None,
) -> Export:
    """Launch K5' (``csrc/gf2_elim.cu``) on CUDA tensors, in the variant of
    :func:`elim_variant` unless ``variant`` forces one."""
    B = _check("masked_export", tg, syndromes, order, count)
    variant = _variant("masked_export", tg, variant)
    dev = syndromes.device
    out = _empty_export(tg, B, dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_masked_export(
                syndromes.data_ptr(), order.data_ptr(), count.data_ptr(),
                tg.packed.data_ptr(), tg.m, tg.n, tg.packed.shape[1], B,
                VARIANTS.index(variant),
                *(t.data_ptr() for t in out), _stream(dev),
            )
        _build.check(lib, rc, "masked_export")
        _count("masked_export", variant)
    return out


def _dispatch(name, reference, cuda, syndromes, *args):
    kind = syndromes.device.type
    if kind == "cpu":
        return reference(*args)
    if kind == "cuda":
        return cuda(*args)
    raise ValueError(f"{name}: no kernel for device {syndromes.device}")


def osd0(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2' on a CUDA tensor, its plain version on a CPU tensor."""
    return _dispatch(
        "osd0", osd0_reference, osd0_cuda, syndromes, tg, syndromes, order, rank
    )


def rref_export(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Export:
    """K3' on a CUDA tensor, its plain version on a CPU tensor."""
    return _dispatch(
        "rref_export", rref_export_reference, rref_export_cuda, syndromes,
        tg, syndromes, order, rank,
    )


def masked_solve(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4' on a CUDA tensor, its plain version on a CPU tensor."""
    return _dispatch(
        "masked_solve", masked_solve_reference, masked_solve_cuda, syndromes,
        tg, syndromes, order, count,
    )


def masked_export(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Export:
    """K5' on a CUDA tensor, its plain version on a CPU tensor."""
    return _dispatch(
        "masked_export", masked_export_reference, masked_export_cuda, syndromes,
        tg, syndromes, order, count,
    )
