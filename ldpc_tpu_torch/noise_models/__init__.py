"""Noise models (reference: src_python/ldpc/noise_models/bsc.py).

A host numpy sampler for the simulation harnesses, and batched samplers
that draw on the device from a caller's ``torch.Generator``, so that a
Monte-Carlo loop's errors never cross the host boundary.
"""

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device


def generate_bsc_error(n: int, error_rate: float) -> np.ndarray:
    """Sample a binary-symmetric-channel error vector
    (reference: bsc.py:4-25)."""
    return np.random.binomial(1, error_rate, n).astype(np.uint8)


def _uniform(generator, batch, n, device) -> torch.Tensor:
    dev = resolve_device(device)
    return torch.rand((batch, n), generator=generator, device=dev)


def generate_bsc_error_batch(
    generator: torch.Generator, batch: int, n: int, error_rate, device="cuda"
) -> torch.Tensor:
    """Batched BSC sampler: (batch, n) uint8 errors on ``device``, drawn
    from ``generator`` (a ``torch.Generator`` on that device)."""
    u = _uniform(generator, batch, n, device)
    return (u < error_rate).to(torch.uint8)


def generate_depolarizing_error_batch(
    generator: torch.Generator, batch: int, n: int, error_rate, device="cuda"
) -> torch.Tensor:
    """Batched depolarizing sampler: (batch, n) uint8 GF(4) errors
    (0=I, 1=X, 2=Y, 3=Z each with p/3) on ``device``.

    Whether a qubit errs and which Pauli it takes are two independent
    draws from ``generator``, so the kind does not depend on ``u``.
    """
    u = _uniform(generator, batch, n, device)
    kinds = torch.randint(
        1, 4, (batch, n), generator=generator, device=u.device, dtype=torch.uint8
    )
    return torch.where(u < error_rate, kinds, torch.zeros_like(kinds))


__all__ = [
    "generate_bsc_error",
    "generate_bsc_error_batch",
    "generate_depolarizing_error_batch",
]
