"""What a BP+OSD decoder owes its caller, computed plainly: every
syndrome's decoding, BP's decision where BP converges within ``max_iter``,
else OSD-CS on the full-depth posterior; and the work a roofline counts: the
BP lanes and their iterations, each lane to its convergence or the cap,
and the elimination counts of the lanes OSD solves.
"""

import numpy as np
import torch

from benchmark.reference import bp, osd
from benchmark.reference.codes import rank

# lanes of one OSD elimination (the packed matrices of a chunk stay under a GB)
_OSD_CHUNK = 2048


def channel_llr(error_rate: float) -> float:
    """log((1 - p) / p) in float64, as float32 holds it."""
    return float(np.float32(np.log((1.0 - error_rate) / error_rate)))


class Decoder:
    """The configuration's decoder, plainly, on one device and dtype."""

    def __init__(self, H: np.ndarray, decoder: dict, device, dtype=torch.float32):
        self.g = bp.graph(H, device)
        self.H = self.g.dense
        self.rank = rank(np.asarray(H, np.uint8))
        self.alpha = float(decoder["ms_scaling_factor"])
        self.max_iter = int(decoder["max_iter"])
        if decoder["osd_method"] != "osd_cs":
            raise ValueError(f"the reference decodes OSD-CS only, not {decoder['osd_method']}")
        self.osd_order = int(decoder.get("osd_order", 0))
        self.dtype = dtype
        self.llr0 = torch.full((self.g.n,), channel_llr(float(decoder["error_rate"])),
                               dtype=torch.float32, device=device)

    def bp(self, syndromes):
        return bp.min_sum(self.g, syndromes, self.llr0, self.alpha, self.max_iter, self.dtype)

    def osd(self, syndromes, posterior):
        """OSD-CS decodings of ``syndromes`` guided by ``posterior``, and
        the elimination work summed over the lanes."""
        out = torch.zeros((syndromes.shape[0], self.g.n), dtype=torch.uint8,
                          device=syndromes.device)
        work = {"lanes": 0, "last_steps": 0, "pivots": 0}
        for a in range(0, syndromes.shape[0], _OSD_CHUNK):
            syn, post = syndromes[a : a + _OSD_CHUNK], posterior[a : a + _OSD_CHUNK]
            order = osd.reliability_order(post)
            x, e = osd.osd_cs(self.H, syn, order, self.rank, self.osd_order)
            out[a : a + _OSD_CHUNK] = x
            work["lanes"] += syn.shape[0]
            work["last_steps"] += int(e.last_steps.sum())
            work["pivots"] += int(e.used.sum())
        return out, work

    def decode(self, syndromes: torch.Tensor):
        """(B, n) uint8 decodings of (B, m) uint8 syndromes, and the work."""
        r = self.bp(syndromes)
        dec = r.decoding.clone()
        failed = torch.nonzero(~r.converged).squeeze(1)
        x, osd_work = self.osd(syndromes[failed], r.posterior[failed])
        dec[failed] = x
        return dec, {"bp_lanes": syndromes.shape[0],
                     "bp_lane_iterations": int(r.iterations.sum()), "osd": osd_work}

