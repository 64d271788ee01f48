"""Kernels K2'-K5': batched GF(2) elimination (counterparts of ``ops/gf2_pallas.py``).

Every kernel here solves H x = s for a batch of lanes by swap-free
Gauss-Jordan over the packed [H | s], taking each lane's columns in its own
order (``order`` (B, n), the caller's stable argsort of the LLRs); the pivot
is the first unused row holding a 1. They differ in when a lane stops and
in what they return:

- ``osd0`` (K2', ``csrc/osd0.cu``): OSD-0. Stops at the syndrome fast exit
  of ``ldpc_tpu/ops/gf2.py::batched_rref(fast_exit=True)`` or at ``rank``
  pivots; returns ``(x0 (B, n) uint8 in original column coordinates,
  valid (B,) bool)``.
- ``rref_export`` (K3', ``csrc/gf2_elim.cu``): runs to ``rank`` pivots and
  exports the reduced matrix.
- ``masked_solve`` (K4'): lane l takes only its first ``count[l]``
  columns; returns ``(x0, bad_row (B, m) bool)``, ``bad_row`` marking the
  unused rows that still hold a syndrome 1.
- ``masked_export`` (K5'): K4's elimination with K3's export.

The export is ``(M (B, m, Wp) int32 words of [R | T s] in original column
coordinates, col_of_row (B, m) int32 pivot column of each row (n if the row
is unused), used (B, m) bool)``; ``Wp = ceil((n+1)/32)`` and the reduced
syndrome is bit ``n`` of each row.

For each kernel, ``*_reference`` is the plain PyTorch version, ``*_cuda``
launches the kernel on CUDA tensors and counts the launch in its own
counter, and the bare name picks by the tensors' device: the CPU runs the
plain version, a CUDA device runs the kernel, anything else raises.
"""

from typing import Optional, Tuple

import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.pcm import TorchGraph

LAUNCHES = 0  # kernel launches made by osd0_cuda
RREF_EXPORT_LAUNCHES = 0  # ... by rref_export_cuda
MASKED_SOLVE_LAUNCHES = 0  # ... by masked_solve_cuda
MASKED_EXPORT_LAUNCHES = 0  # ... by masked_export_cuda

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt in to
_MAX_ROWS = 32 * 1024  # 1024 threads owning at most 32 rows each

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
) -> int:
    """Validate a launch's inputs; return the batch size."""

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
    require(m <= _MAX_ROWS, f"{m} checks exceed the kernel's {_MAX_ROWS}")
    smem = (m * Wp + m) * 4
    require(
        smem <= SMEM_LIMIT,
        f"the working matrix needs {smem} bytes of shared memory, "
        f"more than the card's {SMEM_LIMIT}",
    )
    return B


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _empty_export(tg, B, dev) -> Export:
    return (
        torch.empty((B, tg.m, tg.packed.shape[1]), dtype=torch.int32, device=dev),
        torch.empty((B, tg.m), dtype=torch.int32, device=dev),
        torch.empty((B, tg.m), dtype=torch.bool, device=dev),
    )


def osd0_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2' (``csrc/osd0.cu``) on CUDA tensors: one block per lane."""
    global LAUNCHES
    B = _check("osd0", tg, syndromes, order)
    dev = syndromes.device
    x0 = torch.empty((B, tg.n), dtype=torch.uint8, device=dev)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_osd0(
                syndromes.data_ptr(), order.data_ptr(), tg.packed.data_ptr(),
                tg.m, tg.n, tg.packed.shape[1], int(rank), B, x0.data_ptr(),
                valid.data_ptr(), _stream(dev),
            )
        _build.check(lib, rc, "osd0")
        LAUNCHES += 1
    return x0, valid


def rref_export_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Export:
    """Launch K3' (``csrc/gf2_elim.cu``) on CUDA tensors: one block per lane."""
    global RREF_EXPORT_LAUNCHES
    B = _check("rref_export", tg, syndromes, order)
    dev = syndromes.device
    out = _empty_export(tg, B, dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_rref_export(
                syndromes.data_ptr(), order.data_ptr(), tg.packed.data_ptr(),
                tg.m, tg.n, tg.packed.shape[1], int(rank), B,
                *(t.data_ptr() for t in out), _stream(dev),
            )
        _build.check(lib, rc, "rref_export")
        RREF_EXPORT_LAUNCHES += 1
    return out


def masked_solve_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4' (``csrc/gf2_elim.cu``) on CUDA tensors: one block per lane."""
    global MASKED_SOLVE_LAUNCHES
    B = _check("masked_solve", tg, syndromes, order, count)
    dev = syndromes.device
    x0 = torch.empty((B, tg.n), dtype=torch.uint8, device=dev)
    bad_row = torch.empty((B, tg.m), dtype=torch.bool, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_masked_solve(
                syndromes.data_ptr(), order.data_ptr(), count.data_ptr(),
                tg.packed.data_ptr(), tg.m, tg.n, tg.packed.shape[1], B,
                x0.data_ptr(), bad_row.data_ptr(), _stream(dev),
            )
        _build.check(lib, rc, "masked_solve")
        MASKED_SOLVE_LAUNCHES += 1
    return x0, bad_row


def masked_export_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, count: torch.Tensor
) -> Export:
    """Launch K5' (``csrc/gf2_elim.cu``) on CUDA tensors: one block per lane."""
    global MASKED_EXPORT_LAUNCHES
    B = _check("masked_export", tg, syndromes, order, count)
    dev = syndromes.device
    out = _empty_export(tg, B, dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_masked_export(
                syndromes.data_ptr(), order.data_ptr(), count.data_ptr(),
                tg.packed.data_ptr(), tg.m, tg.n, tg.packed.shape[1], B,
                *(t.data_ptr() for t in out), _stream(dev),
            )
        _build.check(lib, rc, "masked_export")
        MASKED_EXPORT_LAUNCHES += 1
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
