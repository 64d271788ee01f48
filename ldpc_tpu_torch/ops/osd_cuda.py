"""The OSD-w candidate sweep as one CUDA kernel (``csrc/osd_sweep.cu``; the
JAX package sweeps with XLA einsums, ``ldpc_tpu/ops/osd.py``, no Pallas
kernel).

- :func:`ldpc_tpu_torch.ops.osd.sweep_reference` is the plain PyTorch
  version, which the decoder runs on the CPU, in chunks of lanes.
- :func:`sweep_cuda` takes the same arguments on CUDA tensors and sweeps
  every lane in one launch, counted under ``launch.osd_sweep`` and, by
  variant (:func:`sweep_variant`), ``launch.osd_sweep.<variant>``. It
  returns ``(osd0, osdw)``, each (B, n) uint8, equal byte for byte to the
  plain version's on the same device.
"""

from typing import Optional, Tuple

import torch

from ldpc_tpu_torch.ops import _build, gf2
from ldpc_tpu_torch.utils.profiling import count

VARIANTS = ("shared", "device")  # in the order of the library's variant ids

# Shared memory one H100 block can opt in to, less the kernel's static
# shared memory (the block reduction's 32 values and indices) with room
SMEM_BUDGET = 232448 - 1024
_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}


def lane_bytes(m: int, n: int, dtype: torch.dtype) -> int:
    """Shared memory a lane of the shared variant takes at most: its rows of
    K3's export (m rows of ``ceil((n + 1) / 32)`` words, padded to 16
    bytes), the rows' two terms (2 m values of ``dtype``), their bits at the
    first 32 slot columns (m words) and the slot columns (at most n ints);
    ``shared_bytes`` in ``csrc/osd_sweep.cu`` counts the launch's own W
    slots in place of n."""
    rows = -(-4 * m * ((n + 32) // 32) // 16) * 16
    return rows + 2 * m * _ELEM_BYTES[dtype] + 4 * m + 4 * n


def sweep_variant(m: int, n: int, dtype: torch.dtype) -> str:
    """Where the sweep keeps an (m, n) code's lane in ``dtype``:
    ``"shared"`` (staged in shared memory, read from there) while
    :func:`lane_bytes` fits a block, else ``"device"`` (read from device
    memory as K3' left it), for codes above a block's shared memory (toric
    d=31 and up)."""
    return "shared" if lane_bytes(m, n, dtype) <= SMEM_BUDGET else "device"


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"sweep_cuda: {what}")


def _check(words, col_of_row, used, llrs, weights_pad, pats, k) -> None:
    dev = words.device
    _require(dev.type == "cuda", f"words must be on a CUDA device, not {dev}")
    _require(words.dim() == 3, f"words must have shape (B, m, Wp), not {tuple(words.shape)}")
    B, m, Wp = words.shape
    n = weights_pad.shape[0] - 1
    for name, t in (("words", words), ("col_of_row", col_of_row), ("used", used),
                    ("llrs", llrs), ("weights_pad", weights_pad), ("pats", pats)):
        _require(t.device == dev, f"{name} is on {t.device}, words on {dev}")
        _require(name == "llrs" or t.is_contiguous(), f"{name} must be contiguous")
    _require(words.dtype == torch.int32, "words must be int32")
    _require(m >= 1, "the code has no check")
    _require(Wp * 32 >= n + 1, f"words hold {Wp * 32} columns, not n + 1 = {n + 1}")
    _require(col_of_row.dtype == torch.int32 and col_of_row.shape == (B, m),
             f"col_of_row must be int32 of shape ({B}, {m})")
    _require(used.dtype == torch.bool and used.shape == (B, m),
             f"used must be bool of shape ({B}, {m})")
    _require(weights_pad.dtype in _ELEM_BYTES, "weights_pad must be float32 or float64")
    _require(llrs.dtype == weights_pad.dtype and llrs.shape == (B, n),
             f"llrs must be {weights_pad.dtype} of shape ({B}, {n})")
    _require(pats.dtype == torch.bool and pats.dim() == 2, "pats must be a 2-d bool table")
    _require(0 <= k <= n, f"k must lie in 0..{n}, not {k}")
    _require(pats.shape[0] == 0 or pats.shape[1] <= k,
             f"a pattern of {pats.shape[1]} slots over {k} non-pivot columns")


def sweep_cuda(
    words: torch.Tensor, col_of_row: torch.Tensor, used: torch.Tensor, llrs: torch.Tensor,
    weights_pad: torch.Tensor, pats: torch.Tensor, k: int, use_singles: bool,
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/osd_sweep.cu`` on CUDA tensors: the arguments of
    :func:`ldpc_tpu_torch.ops.osd.sweep_reference`, in the variant of
    :func:`sweep_variant` unless ``variant`` forces one (tests and
    measurement only). Each lane's non-pivot columns are ordered as the
    plain version orders them, by the same ``torch.argsort`` launch over
    every lane; the pattern table goes to the kernel packed, 32 slots a
    word."""
    _check(words, col_of_row, used, llrs, weights_pad, pats, k)
    B, m, Wp = words.shape
    n = weights_pad.shape[0] - 1
    if variant is None:
        variant = sweep_variant(m, n, weights_pad.dtype)
    _require(variant in VARIANTS, f"variant must be one of {VARIANTS}, not {variant!r}")
    dev = words.device
    osd0 = torch.empty((B, n), dtype=torch.uint8, device=dev)
    osdw = torch.empty((B, n), dtype=torch.uint8, device=dev)
    if B == 0:
        return osd0, osdw
    target = torch.where(used, col_of_row.long(), n)
    ispiv = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    ispiv.scatter_(1, target, used)
    # non-pivot columns first, least reliable first (ties: column order)
    order = torch.argsort(torch.where(ispiv[:, :n], torch.inf, llrs), dim=1, stable=True)
    P, W = pats.shape
    masks = gf2.pack_u32(pats).contiguous() if P else pats.new_zeros((0, 1), dtype=torch.int32)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.ldpc_osd_sweep(
            words.data_ptr(), col_of_row.data_ptr(), used.data_ptr(), order.data_ptr(),
            weights_pad.data_ptr(), masks.data_ptr(), m, n, Wp, k, W if P else 0,
            masks.shape[1], P, int(use_singles), int(weights_pad.dtype == torch.float64), B,
            VARIANTS.index(variant), osd0.data_ptr(), osdw.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "osd_sweep")
    count("launch.osd_sweep")
    count("launch.osd_sweep." + variant)
    return osd0, osdw
