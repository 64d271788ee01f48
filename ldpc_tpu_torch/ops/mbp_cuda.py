"""Kernel K9': batched MBP over GF(4) (counterpart of the XLA loop
``ldpc_tpu/ops/mbp.py::make_mbp_decoder``; no Pallas kernel).

- :func:`ldpc_tpu_torch.ops.mbp.mbp_reference` is the plain PyTorch
  version.
- :func:`mbp_cuda` launches ``csrc/mbp.cu`` on CUDA tensors and counts the
  launch under ``launch.mbp``, and by dtype under ``launch.mbp.<dtype>``; its
  persistent warps claim lanes from a counter the wrapper zeroes, and its
  scratch has a row a warp of the grid that :func:`launch_shape` reports:
  each warp's cache, and its slice where the slices do not fit shared
  memory at the SM's full residency.
- :func:`mbp` picks by the tensors' device: the CPU runs the plain
  version, a CUDA device runs the kernel, anything else raises.
"""

import ctypes
from typing import NamedTuple

import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.mbp import MINIMUM_SUM, PRODUCT_SUM, Gf4Torch, mbp_reference
from ldpc_tpu_torch.utils.profiling import count


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"mbp_cuda: {what}")


class LaunchShape(NamedTuple):
    """K9''s launch for a code, a scalar type and a batch."""

    blocks: int  # of the grid: those the card holds at once, no more than the lanes need
    warps: int  # a block, a lane each at a time
    resident_warps: int  # on an SM (the occupancy of the registers)
    registers: int  # a thread
    local_bytes: int  # a thread's spills
    shared_bytes: int  # a block: its warps' slices, or 0 where they are in device memory
    cache_values: int  # a warp's row of the cache scratch: m rows of dc padded to 16 bytes
    slice_bytes: int  # a warp's slice: level messages and posteriors, decisions, syndrome
    scratch_bytes: int  # the device scratch, a row a warp of the grid

    @property
    def slices_in_shared(self) -> bool:
        return self.shared_bytes > 0


def launch_shape(g: Gf4Torch, dtype: torch.dtype, bp_method: int, B: int) -> LaunchShape:
    """Ask the library for K9''s launch shape (on the current CUDA device)."""
    out = (ctypes.c_int * 8)()
    lib = _build.library()
    rc = lib.ldpc_mbp_shape(g.max_pairs, g.max_level, g.m, g.n, g.dc,
                            int(bp_method == MINIMUM_SUM), int(dtype == torch.float64), B,
                            ctypes.addressof(out))
    _build.check(lib, rc, "mbp")
    blocks, warps, per_sm, regs, local, smem, row, slice_bytes = out
    per_warp = row * dtype.itemsize + (0 if smem else slice_bytes)
    return LaunchShape(blocks, warps, per_sm * warps, regs, local, smem, row, slice_bytes,
                       blocks * warps * per_warp)


def mbp_cuda(
    g: Gf4Torch,
    syndromes: torch.Tensor,
    chan: torch.Tensor,
    inv_alpha: torch.Tensor,
    max_iter: int,
    beta: float,
    bp_method: int,
    gamma: float,
):
    """Launch K9' (``csrc/mbp.cu``) on CUDA tensors: persistent warps, each
    claiming a lane at a time, the sweep a level of real pairs a step, each
    warp's cache (and its slice, where :func:`launch_shape` puts the slices
    in device memory) in a device scratch of that shape's grid. ``chan`` and
    ``inv_alpha`` are (3, n) in float32 or float64, the kernel's scalar
    type. Returns
    ``(decoding (B, n) uint8, llrs (B, 3, n), converged (B,) bool,
    iterations (B,) int32)``."""
    dev = syndromes.device
    m, n, dc, dv = g.m, g.n, g.dc, g.dv
    dt = chan.dtype
    _require(dev.type == "cuda", f"syndromes must be on a CUDA device, not {dev}")
    for name, t in (
        ("syndromes", syndromes), ("chan", chan), ("inv_alpha", inv_alpha),
        ("chk_bits", g.chk_bits), ("chk_val", g.chk_val), ("lv_bits", g.lv_bits),
        ("lv_ptr", g.lv_ptr), ("pair_ptr", g.pair_ptr), ("pairs", g.pairs),
    ):
        _require(t.device == dev, f"{name} is on {t.device}, syndromes on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(syndromes.dtype == torch.uint8, "syndromes must be uint8")
    _require(
        syndromes.dim() == 2 and syndromes.shape[1] == m,
        f"syndromes must have shape (B, {m}), not {tuple(syndromes.shape)}",
    )
    _require(dt in (torch.float32, torch.float64), "chan must be float32 or float64")
    _require(inv_alpha.dtype == dt, "inv_alpha must have chan's dtype")
    _require(chan.shape == (3, n) and inv_alpha.shape == (3, n), f"chan and inv_alpha must be (3, {n})")
    for name, t, want in (("chk_bits", g.chk_bits, torch.int32), ("lv_bits", g.lv_bits, torch.int32),
                          ("lv_ptr", g.lv_ptr, torch.int32), ("pair_ptr", g.pair_ptr, torch.int32),
                          ("pairs", g.pairs, torch.int32), ("chk_val", g.chk_val, torch.uint8)):
        _require(t.dtype == want, f"{name} must be {want}")
    _require(bp_method in (PRODUCT_SUM, MINIMUM_SUM), f"bp_method must be 0 or 1, not {bp_method}")
    _require(max_iter >= 0, "max_iter must be >= 0")
    B = syndromes.shape[0]
    # every qubit's posterior is written in the first sweep; none at depth 0
    llr = (torch.empty if max_iter else torch.zeros)((B, 3, n), dtype=dt, device=dev)
    dec = torch.empty((B, n), dtype=torch.uint8, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            shape = launch_shape(g, dt, bp_method, B)
            warps = shape.blocks * shape.warps
            cache = torch.empty((warps, shape.cache_values), dtype=dt, device=dev)
            slices = None if shape.slices_in_shared else torch.empty(
                (warps, shape.slice_bytes), dtype=torch.uint8, device=dev)
            nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the lanes' claim counter
            rc = lib.ldpc_mbp(
                syndromes.data_ptr(), chan.data_ptr(), inv_alpha.data_ptr(),
                g.chk_bits.data_ptr(), g.chk_val.data_ptr(), g.lv_bits.data_ptr(),
                g.lv_ptr.data_ptr(), g.pair_ptr.data_ptr(), g.pairs.data_ptr(), g.levels,
                g.max_pairs, g.max_level, m, n, dc, dv, B, max_iter,
                int(bp_method == MINIMUM_SUM), int(dt == torch.float64), float(beta),
                float(gamma), shape.blocks, nxt.data_ptr(), cache.data_ptr(),
                0 if slices is None else slices.data_ptr(), llr.data_ptr(), dec.data_ptr(),
                conv.data_ptr(), iters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "mbp")
        count("launch.mbp")
        count("launch.mbp." + str(dt).removeprefix("torch."))
    return dec, llr, conv, iters


def mbp(
    g: Gf4Torch,
    syndromes: torch.Tensor,
    chan: torch.Tensor,
    inv_alpha: torch.Tensor,
    max_iter: int,
    beta: float,
    bp_method: int,
    gamma: float,
):
    """K9' on a CUDA tensor, its plain version on a CPU tensor."""
    kind = syndromes.device.type
    if kind == "cpu":
        return mbp_reference(g, syndromes, chan, inv_alpha, max_iter, beta, bp_method, gamma)
    if kind == "cuda":
        return mbp_cuda(g, syndromes, chan, inv_alpha, max_iter, beta, bp_method, gamma)
    raise ValueError(f"mbp: no kernel for device {syndromes.device}")
