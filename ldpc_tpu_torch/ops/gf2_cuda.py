"""Kernel K2': batched OSD-0 elimination (counterpart of ``ops/gf2_pallas.py``).

- :func:`osd0_reference` is the plain PyTorch version: swap-free
  Gauss-Jordan over the packed [H | s] with the fast exit of
  ``ldpc_tpu/ops/gf2.py::batched_rref(fast_exit=True, with_transform=False)``,
  taking each lane's columns in its own order.
- :func:`osd0_cuda` launches ``csrc/osd0.cu`` on a CUDA tensor and counts
  the launch in :data:`LAUNCHES`.
- :func:`osd0` picks by the tensors' device: the CPU runs the plain
  version, a CUDA device runs the kernel, anything else raises.

All three take ``order`` (B, n), the columns of each lane in processing
order (the caller's stable argsort of the posterior LLRs), and return
``(x0 (B, n) uint8 in original column coordinates, valid (B,) bool)``.
"""

from typing import Tuple

import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.pcm import TorchGraph

LAUNCHES = 0  # kernel launches made by osd0_cuda

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt in to
_MAX_ROWS = 32 * 1024  # 1024 threads owning at most 32 rows each


def osd0_reference(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch OSD-0 on (B, m) uint8 syndromes."""
    m, n = tg.m, tg.n
    B = syndromes.shape[0]
    dev = syndromes.device
    ws, bs = n // 32, n % 32  # syndrome column's word and bit
    order = order.long()
    # words as non-negative int64 holding 32 bits each: no sign games
    M = (tg.packed.to(torch.int64) & 0xFFFFFFFF).unsqueeze(0).repeat(B, 1, 1)
    M[:, :, ws] |= syndromes.to(torch.int64) << bs
    rows = torch.arange(m, device=dev)
    lanes = torch.arange(B, device=dev)
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    col_of_row = torch.zeros((B, m), dtype=torch.int64, device=dev)
    used_cnt = torch.zeros(B, dtype=torch.int64, device=dev)

    def sbit():
        return ((M[:, :, ws] >> bs) & 1).bool()

    active = sbit().any(dim=1) & (rank > 0)
    for j in range(n):
        if not bool(active.any()):
            break
        c = order[:, j]
        w, bit = c >> 5, c & 31
        colw = torch.gather(M, 2, w.view(B, 1, 1).expand(B, m, 1)).squeeze(2)
        # finished lanes are frozen, as the kernel stops them
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
        active = active & (sbit() & ~used).any(dim=1) & (used_cnt < rank)

    sb = sbit()
    valid = ~(sb & ~used).any(dim=1)
    x0 = torch.zeros((B, n + 1), dtype=torch.uint8, device=dev)
    target = torch.where(used, col_of_row, n)  # unused rows -> dummy column
    x0.scatter_(1, target, (sb & used).to(torch.uint8))
    return x0[:, :n].contiguous(), valid


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"osd0_cuda: {what}")


def osd0_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2' (``csrc/osd0.cu``) on CUDA tensors: one block per lane."""
    global LAUNCHES
    dev = syndromes.device
    m, n = tg.m, tg.n
    Wp = tg.packed.shape[1]
    _require(dev.type == "cuda", f"syndromes must be on a CUDA device, not {dev}")
    for name, t in (("order", order), ("packed", tg.packed)):
        _require(t.device == dev, f"{name} is on {t.device}, syndromes on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(syndromes.is_contiguous(), "syndromes must be contiguous")
    _require(syndromes.dtype == torch.uint8, "syndromes must be uint8")
    _require(
        syndromes.dim() == 2 and syndromes.shape[1] == m,
        f"syndromes must have shape (B, {m}), not {tuple(syndromes.shape)}",
    )
    B = syndromes.shape[0]
    _require(order.dtype == torch.int32, "order must be int32")
    _require(order.shape == (B, n), f"order must have shape ({B}, {n})")
    _require(tg.packed.dtype == torch.int32, "packed H must be int32 words")
    _require(Wp * 32 >= n + 1, "packed H has no room for the syndrome column")
    _require(m <= _MAX_ROWS, f"{m} checks exceed the kernel's {_MAX_ROWS}")
    smem = (m * Wp + m) * 4
    _require(
        smem <= SMEM_LIMIT,
        f"the working matrix needs {smem} bytes of shared memory, "
        f"more than the card's {SMEM_LIMIT}",
    )
    x0 = torch.empty((B, n), dtype=torch.uint8, device=dev)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_osd0(
                syndromes.data_ptr(), order.data_ptr(), tg.packed.data_ptr(),
                m, n, Wp, int(rank), B, x0.data_ptr(), valid.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "osd0")
        LAUNCHES += 1
    return x0, valid


def osd0(
    tg: TorchGraph, syndromes: torch.Tensor, order: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2' on a CUDA tensor, its plain version on a CPU tensor."""
    kind = syndromes.device.type
    if kind == "cpu":
        return osd0_reference(tg, syndromes, order, rank)
    if kind == "cuda":
        return osd0_cuda(tg, syndromes, order, rank)
    raise ValueError(f"osd0: no kernel for device {syndromes.device}")
