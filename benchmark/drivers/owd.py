"""Closed loop of ``BpOsdOverlappingWindowDecoder.decode_batch`` as sinter
calls it: bit-packed detection events in hand, bit-packed predictions and
corrections back (``return_corrections``), the next call when the last
returns.

The configuration's phenomenological memory experiment is built by
``reference/phenom.py``, as matrices for the reference and behind stim's
instruction interface for the program, which converts it itself. A shot
is one detector record of every round: each mechanism flips at its prior,
drawn on the device from the seed in set-up; its detectors go to the
decoder packed little-endian (``ceil(detectors / 8)`` bytes), and its
observable flip, which sinter keeps apart from the decoder, is not kept.
The check holds the kept calls' corrections against ``reference/owd.py``'s
on the same shots, and their predictions against the observable flips of
the reference's corrections.

Traffic keys: ``batch`` (shots a call), ``pool`` (distinct batches drawn in
set-up and cycled), ``warm_calls``, ``check_calls`` (calls kept for the
comparison), ``trace_calls``, ``gap_calls``, ``sync_calls`` and
``span_calls`` (the traced run's slices); ``test`` and ``control_test``,
the sizes that the CPU tests put in their place.
"""

from collections import Counter

import numpy as np
import torch

from benchmark import inputs, judge
from benchmark.program import owd as program
from benchmark.reference import owd as ref
from benchmark.reference import phenom

# a window's work that adds up over shots; its sizes do not
COUNTS = ("bp_lanes", "bp_lane_iterations", "osd_lanes", "osd_steps", "osd_pivots",
          "osd_pivot_words")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        d, n = cfg["code"]["distance"], cfg["noise"]
        assert cfg["code"]["family"] == "surface"
        assert cfg["decodings"] == (cfg["rounds"] - cfg["window"]) // cfg["commit"] + 1
        args = (d, cfg["rounds"], n["p"], n["q"])
        self.dem = phenom.surface_memory(*args)
        self.decoder = program.bposd_owd(cfg, phenom.StimLikeDem.surface_memory(*args), device)
        self.pool = self._pool(seed)

    def _pool(self, seed):
        t = self.traffic
        gen = torch.Generator(device=self.device)
        gen.manual_seed(inputs.stream_seed(seed, 1))
        H = torch.from_numpy(self.dem.H.astype(np.float32)).to(self.device)
        priors = torch.from_numpy(self.dem.priors.astype(np.float32)).to(self.device)
        pool = []
        for _ in range(t["pool"]):
            e = torch.rand((t["batch"], H.shape[1]), generator=gen, device=self.device) < priors
            dets = (e.to(torch.float32) @ H.t()) % 2  # 0/1 sums of a row's weight: exact
            pool.append(np.packbits(dets.to(torch.uint8).cpu().numpy(), axis=1,
                                    bitorder="little"))
        return pool

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.call(i)

    def call(self, i: int):
        """Call ``i``; returns ``(shots, (pool index, packed predictions,
        packed corrections))``."""
        k = i % len(self.pool)
        predictions, corrections = self.decoder.decode_batch(
            self.pool[k], bit_packed_shots=True, bit_packed_predictions=True,
            return_corrections=True)
        return corrections.shape[0], (k, predictions, corrections)

    @staticmethod
    def keep(out):
        k, p, x = out
        return k, np.array(p, copy=True), np.array(x, copy=True)

    def free(self):
        """Drop the program's state before the reference runs."""
        self.decoder = None

    def _shots(self, ks) -> np.ndarray:
        packed = np.concatenate([self.pool[k] for k in ks])
        return np.unpackbits(packed, axis=1, count=self.dem.H.shape[0], bitorder="little")

    def _reference(self, shots: np.ndarray, dtype=torch.float32):
        c, d = self.cfg, self.cfg["decoder"]
        return ref.decode(self.dem.H, self.dem.priors, torch.from_numpy(shots).to(self.device),
                          c["decodings"], c["window"], c["commit"], self.dem.num_checks,
                          d["max_iter"], d["ms_scaling_factor"], dtype)

    def _predictions(self, corrections: np.ndarray) -> np.ndarray:
        """The observables' flips of (B, N) uint8 corrections, (B, O) uint8."""
        obs = self.dem.obs.astype(np.int64)
        return ((corrections.astype(np.int64) @ obs.T) % 2).astype(np.uint8)

    def judge(self, kept, control: bool = False) -> dict:
        """The compared numbers of the kept calls' corrections and
        predictions; with ``control`` the reference in bfloat16 stands in for
        the program. ``predictions_off`` counts the checked shots whose
        predictions differ from the reference's corrections' observables."""
        shots = self._shots([k for k, _, _ in kept])
        want = self._reference(shots)[0].cpu().numpy()
        if control:
            got = self._reference(shots, torch.bfloat16)[0].cpu().numpy()
            predictions = self._predictions(got)
        else:
            got = np.unpackbits(np.concatenate([x for _, _, x in kept]), axis=1,
                                count=self.dem.H.shape[1], bitorder="little")
            predictions = np.unpackbits(np.concatenate([p for _, p, _ in kept]), axis=1,
                                        count=self.dem.obs.shape[0], bitorder="little")
        numbers = judge.decodings(self.dem.H, shots, got, want, self.device)
        off = np.any(predictions != self._predictions(want), axis=1)
        return {**numbers, "predictions_off": int(off.sum())}

    def failed(self, numbers: dict) -> int:
        """Checked shots whose correction breaks H x = s."""
        return numbers["syndrome_misses"]

    def work(self, calls) -> dict:
        """The reference's work on the shots of the calls ``calls`` (the
        rooflines'), window by window: each distinct batch decoded once, its
        work counted as often as the calls ran it."""
        windows = None
        for k, c in Counter(i % len(self.pool) for i in calls).items():
            _, got = self._reference(self._shots([k]))
            if windows is None:
                windows = [{key: 0 if key in COUNTS else v for key, v in w.items()} for w in got]
            for total, w in zip(windows, got):
                for key in COUNTS:
                    total[key] += c * w[key]
        return {"windows": windows or []}

    def sizes(self) -> dict:
        """The cell's rooflines take each window's sizes from ``work``."""
        return {}
