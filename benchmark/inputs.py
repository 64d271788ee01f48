"""Syndromes the benchmark hands to the program and to the reference.

Each seed gives the same pool on the same kind of device: errors are drawn
on the device by a ``torch.Generator`` seeded from ``(seed, stream)``, a
bit flipped with the configuration's error rate, and the syndromes
``H e mod 2`` are copied to the host once, in set-up.
"""

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0])


def syndrome_pool(hx: np.ndarray, error_rate: float, rows: int, batches: int, seed: int,
                  device) -> list:
    """``batches`` (rows, m) uint8 numpy arrays of syndromes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1))
    H = torch.from_numpy(np.asarray(hx, np.float32)).to(device)
    pool = []
    for _ in range(batches):
        e = (torch.rand((rows, H.shape[1]), generator=gen, device=device) < error_rate)
        syn = (e.to(torch.float32) @ H.t()) % 2  # 0/1 sums: exact in float32
        pool.append(syn.to(torch.uint8).cpu().numpy())
    return pool
