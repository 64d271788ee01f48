"""The comparison that decides ``correct``.

Every checked syndrome's decoding against the plain reference's:
``decodings_off_pct``, the share of the checked shots whose decoding
differs in any bit, and ``syndrome_misses``, the checked decodings x with
H x != s (OSD guarantees H x = s for every syndrome of these codes).

A number passes when it is at most its limit (``benchmark/limits/<cell>.json``).
"""

import numpy as np
import torch

from benchmark.reference import decode as ref


def decodings(H: np.ndarray, syndromes: np.ndarray, got: np.ndarray, want: np.ndarray,
              device) -> dict:
    off = np.any(got != want, axis=1)
    Ht = torch.from_numpy(np.asarray(H, np.float32).T).to(device)
    x = torch.from_numpy(got).to(device).to(torch.float32)
    s = torch.from_numpy(syndromes).to(device)
    # 0/1 sums of at most a row's weight: exact in float32
    misses = ((x @ Ht) % 2).to(torch.uint8).ne(s).any(dim=1).cpu().numpy()
    return {"decodings_off_pct": 100.0 * float(off.mean()) if len(off) else 0.0,
            "syndrome_misses": int(misses.sum())}


def reference_decodings(H: np.ndarray, decoder: dict, syndromes: np.ndarray, device,
                        dtype=torch.float32, rows: int = 65536) -> np.ndarray:
    d = ref.Decoder(H, decoder, device, dtype)
    out = []
    for a in range(0, len(syndromes), rows):
        x, _ = d.decode(torch.from_numpy(syndromes[a : a + rows]).to(device))
        out.append(x.cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, H.shape[1]), np.uint8)


def verdict(numbers: dict, limits: dict):
    """``(correct, checks)``: each number beside its limit, in the limits' order."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
