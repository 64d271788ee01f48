"""Closed loop of ``BpOsdDecoder.decode_batch``: numpy syndromes in hand,
numpy decodings back, the next call when the last returns.

Traffic keys: ``batch`` (syndromes a call), ``pool`` (distinct batches
drawn in set-up and cycled), ``warm_calls``, ``check_calls`` (calls kept
for the comparison), ``trace_calls`` (calls of the device-profiled slice),
``gap_calls`` (calls of the host-profiled slice), ``sync_calls`` (calls
whose host syncs are counted); ``test`` and ``control_test``, the sizes
that the CPU tests put in their place.
"""

from collections import Counter, defaultdict

import numpy as np
import torch

from benchmark import inputs, judge, program
from benchmark.reference import codes
from benchmark.reference import decode as ref


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.hx = codes.build(cfg["code"])
        self.params = program.reference_params(cfg)
        self.decoder = program.bposd_decoder(cfg, self.hx, device)
        self.pool = self._pool(seed)

    def _pool(self, seed):
        t = self.traffic
        return inputs.syndrome_pool(self.hx, self.params["error_rate"], t["batch"], t["pool"],
                                    seed, self.device)

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.call(i)

    def call(self, i: int):
        """Call ``i``; returns ``(shots, (pool index, output))``."""
        k = i % len(self.pool)
        out = self.decoder.decode_batch(self.pool[k])
        return out.shape[0], (k, out)

    @staticmethod
    def keep(out):
        """What the comparison keeps of a call: its pool index and a copy of
        its output, so that the program's own buffer is not held."""
        k, x = out
        return k, np.array(x, copy=True)

    def free(self):
        """Drop the program's state before the reference runs."""
        self.decoder = None

    def _inputs(self, ks):
        return np.concatenate([self.pool[k] for k in ks])

    def judge(self, kept, control: bool = False) -> dict:
        """The compared numbers of the kept calls' decodings; with
        ``control`` the reference in bfloat16 stands in for the program."""
        syn = self._inputs([k for k, _ in kept])
        want = judge.reference_decodings(self.hx, self.params, syn, self.device)
        if control:
            got = judge.reference_decodings(self.hx, self.params, syn, self.device,
                                            torch.bfloat16)
        else:
            got = np.concatenate([out.reshape(-1, self.hx.shape[1]) for _, out in kept])
        return judge.decodings(self.hx, syn, got, want, self.device)

    def failed(self, numbers: dict) -> int:
        """Checked shots whose decoding breaks H x = s."""
        return numbers["syndrome_misses"]

    def work(self, calls, rows: int = 65536) -> dict:
        """The reference's work on the inputs of the calls ``calls`` (the
        rooflines'): each distinct input decoded once, its work counted as
        often as the calls ran it."""
        d = ref.Decoder(self.hx, self.params, self.device)
        by_count = defaultdict(list)
        for k, c in Counter(i % len(self.pool) for i in calls).items():
            by_count[c].append(k)
        total = {}
        for c, ks in by_count.items():
            syn = self._inputs(ks)
            for a in range(0, len(syn), rows):
                w = d.decode(torch.from_numpy(syn[a : a + rows]).to(self.device))[1]
                total = _add(total, w, c)
        return total

    def sizes(self) -> dict:
        H = self.hx
        return {"m": H.shape[0], "n": H.shape[1], "dc": int(H.sum(1).max()),
                "dv": int(H.sum(0).max()), "nnz": int(H.sum())}


def _add(total: dict, w: dict, c: int) -> dict:
    """``total + c * w``, key by key, nested."""
    return {k: _add(total.get(k, {}), v, c) if isinstance(v, dict) else total.get(k, 0) + c * v
            for k, v in w.items()}
