"""GF(2) packing helpers on torch tensors (port of ``ldpc_tpu.ops.gf2``).

Packed words are LSB-first, 32 columns per word, exactly as in the JAX
package. torch has no shifts for ``uint32`` on the CPU, so a packed word
is held as the ``int32`` with the same bit pattern (bit 31 set reads as a
negative number); the CUDA kernels read the same memory as ``uint32_t``.
"""

import numpy as np
import torch

from ldpc_tpu_torch import mod2


def column_order(keys: torch.Tensor) -> torch.Tensor:
    """Each row's stable ascending argsort of the float ``keys`` (int64
    indices), every NaN last, as the JAX package's sort and torch's CPU sort place them: torch's
    CUDA sort (a radix sort on the bit pattern) puts a NaN whose sign bit is
    set before -inf, so every NaN is made the positive quiet NaN first."""
    keys = torch.where(torch.isnan(keys), torch.full_like(keys, float("nan")), keys)
    return torch.argsort(keys, dim=-1, stable=True)


def pack_u32(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) 0/1 tensor into (..., ceil(n/32)) int32 words."""
    n = bits.shape[-1]
    W = -(-n // 32)
    pad = W * 32 - n
    words = bits.to(torch.int64)
    if pad:
        words = torch.nn.functional.pad(words, (0, pad))
    words = words.reshape(bits.shape[:-1] + (W, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = (words << shifts).sum(dim=-1)  # 0 .. 2^32-1 in int64
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_u32(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_u32`: (..., W) int32 words -> (..., n) uint8.

    int32 words are shifted as they are: an arithmetic shift by t keeps
    bit t lowest even where bit 31 makes the word negative.
    """
    dtype = torch.int32 if words.dtype == torch.int32 else torch.int64
    shifts = torch.arange(32, dtype=dtype, device=words.device)
    bits = (words.to(dtype)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].to(torch.uint8)


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) 0/1 tensor into (..., ceil(n/8)) uint8 (LSB-first),
    the layout ``np.unpackbits(..., bitorder='little')`` reads."""
    n = bits.shape[-1]
    W = -(-n // 8)
    pad = W * 8 - n
    by = bits.to(torch.int32)
    if pad:
        by = torch.nn.functional.pad(by, (0, pad))
    by = by.reshape(bits.shape[:-1] + (W, 8))
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (by << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bits_u8(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_bits_u8` (numpy)."""
    return np.unpackbits(
        np.asarray(packed, np.uint8), axis=-1, count=n, bitorder="little"
    )


def unpack_bits_u8_device(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side inverse of :func:`pack_bits_u8`."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :n].to(torch.uint8)


def batched_rank(dense: np.ndarray) -> int:
    """GF(2) rank of a dense 0/1 matrix (host, order-invariant)."""
    return mod2.rank(np.asarray(dense, dtype=np.uint8))
