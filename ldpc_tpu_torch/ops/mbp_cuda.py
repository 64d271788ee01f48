"""Kernel K9': batched MBP over GF(4) (counterpart of the XLA loop
``ldpc_tpu/ops/mbp.py::make_mbp_decoder``; no Pallas kernel).

- :func:`ldpc_tpu_torch.ops.mbp.mbp_reference` is the plain PyTorch
  version.
- :func:`mbp_cuda` launches ``csrc/mbp.cu`` on CUDA tensors and counts the
  launch in :data:`LAUNCHES`, and by dtype in :data:`DTYPE_LAUNCHES`.
- :func:`mbp` picks by the tensors' device: the CPU runs the plain
  version, a CUDA device runs the kernel, anything else raises.
"""

import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.mbp import MINIMUM_SUM, PRODUCT_SUM, Gf4Torch, mbp_reference

LAUNCHES = 0  # kernel launches made by mbp_cuda
# ... of them by the scalar type
DTYPE_LAUNCHES = {"float32": 0, "float64": 0}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"mbp_cuda: {what}")


def _pairs(g: Gf4Torch) -> int:
    """Message slots of a lane's scratch: the widest level's qubits times dv."""
    return max(1, g.max_level * g.dv)


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
    """Launch K9' (``csrc/mbp.cu``) on CUDA tensors: one warp a lane, the
    sweep a level of qubits a step, each lane's cache and messages in a
    device scratch. ``chan`` and ``inv_alpha`` are (3, n) in float32 or
    float64, the kernel's scalar type. Returns
    ``(decoding (B, n) uint8, llrs (B, 3, n), converged (B,) bool,
    iterations (B,) int32)``."""
    global LAUNCHES
    dev = syndromes.device
    m, n, dc, dv = g.m, g.n, g.dc, g.dv
    dt = chan.dtype
    _require(dev.type == "cuda", f"syndromes must be on a CUDA device, not {dev}")
    for name, t in (
        ("syndromes", syndromes), ("chan", chan), ("inv_alpha", inv_alpha),
        ("chk_bits", g.chk_bits), ("chk_val", g.chk_val), ("var_chks", g.var_chks),
        ("var_slot", g.var_slot), ("var_val", g.var_val), ("lv_bits", g.lv_bits),
        ("lv_ptr", g.lv_ptr),
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
    for name, t, want in (("chk_bits", g.chk_bits, torch.int32), ("var_chks", g.var_chks, torch.int32),
                          ("var_slot", g.var_slot, torch.int32), ("lv_bits", g.lv_bits, torch.int32),
                          ("lv_ptr", g.lv_ptr, torch.int32), ("chk_val", g.chk_val, torch.uint8),
                          ("var_val", g.var_val, torch.uint8)):
        _require(t.dtype == want, f"{name} must be {want}")
    _require(bp_method in (PRODUCT_SUM, MINIMUM_SUM), f"bp_method must be 0 or 1, not {bp_method}")
    _require(max_iter >= 0, "max_iter must be >= 0")
    B = syndromes.shape[0]
    P = _pairs(g)
    cache = torch.empty((B, m * dc), dtype=dt, device=dev)
    msg = torch.empty((B, P), dtype=dt, device=dev)
    # every qubit's posterior is written in the first sweep; none at depth 0
    llr = (torch.empty if max_iter else torch.zeros)((B, 3, n), dtype=dt, device=dev)
    dec = torch.empty((B, n), dtype=torch.uint8, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_mbp(
                syndromes.data_ptr(), chan.data_ptr(), inv_alpha.data_ptr(),
                g.chk_bits.data_ptr(), g.chk_val.data_ptr(), g.var_chks.data_ptr(),
                g.var_slot.data_ptr(), g.var_val.data_ptr(), g.lv_bits.data_ptr(),
                g.lv_ptr.data_ptr(), g.levels, P, m, n, dc, dv, B, max_iter,
                int(bp_method == MINIMUM_SUM), int(dt == torch.float64),
                float(beta), float(gamma), cache.data_ptr(), msg.data_ptr(), llr.data_ptr(), dec.data_ptr(),
                conv.data_ptr(), iters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "mbp")
        LAUNCHES += 1
        DTYPE_LAUNCHES[str(dt).removeprefix("torch.")] += 1
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
