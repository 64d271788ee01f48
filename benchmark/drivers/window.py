"""Closed loop of ``make_window_decoder``'s decode in analog mode: a batch
of recorded syndrome histories and their analog values, resident on the
device, in hand; the total corrections and the summed BP iterations back
as numpy; the next call when the last returns.

The configuration's phenomenological memory run is drawn on the device in
set-up, from the seed, into ``pool`` batches: each round flips each data
bit at ``p`` (the error accumulates over the rounds), round r's syndrome is
``H e_r``, and every round but the perfect last is read as the analog
values ``a = (1 - 2 s) + sigma N(0, 1)``, with ``sigma`` the one whose hard
decision ``a < 0`` flips at ``q``; the last round's values are ``1 - 2 s``
exactly. A shot is its (m, rounds) uint8 history (``a < 0``) with its
(m, rounds) float32 values. A call is ``program/window.py``'s
``decode_to_host``: the decode and the copies of its results to numpy,
under one root span. The check holds the kept calls' corrections
and iterations against ``reference/window.py``'s on the same shots.

Traffic keys: ``batch`` (shots a call), ``pool`` (distinct batches drawn in
set-up and cycled), ``warm_calls``, ``check_calls`` (calls kept for the
comparison), ``trace_calls``, ``gap_calls``, ``sync_calls`` and
``span_calls`` (the traced run's slices); ``test`` and ``control_test``,
the sizes that the CPU tests put in their place.
"""

from collections import Counter

import numpy as np
import torch

from benchmark import inputs
from benchmark.program import window as program
from benchmark.reference import codes
from benchmark.reference import window as ref

# a window's work that adds up over shots; its sizes do not
COUNTS = ("bp_lanes", "bp_lane_iterations", "osd_lanes", "osd_steps", "osd_pivots",
          "osd_pivot_words")


def histories(H: np.ndarray, rounds: int, p: float, sigma: float, batch: int,
              gen: torch.Generator, device):
    """One batch: ``(syndromes (batch, m, rounds) uint8, analog values
    (batch, m, rounds) float32)`` on ``device``, drawn from ``gen``."""
    Ht = torch.from_numpy(np.asarray(H, np.float32).T).to(device)
    m, n = H.shape
    err = torch.zeros((batch, n), dtype=torch.float32, device=device)
    syn = torch.empty((batch, m, rounds), dtype=torch.uint8, device=device)
    ana = torch.empty((batch, m, rounds), dtype=torch.float32, device=device)
    for r in range(rounds):
        flips = torch.rand((batch, n), generator=gen, device=device) < p
        err = (err + flips.to(torch.float32)) % 2
        s = (err @ Ht) % 2  # 0/1 sums of a row's weight: exact in float32
        a = 1.0 - 2.0 * s
        if r < rounds - 1:
            a = a + sigma * torch.randn((batch, m), generator=gen, device=device)
        ana[:, :, r] = a
        syn[:, :, r] = a < 0
    return syn, ana


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        assert cfg["code"]["family"] == "surface" and cfg["noise"]["readout"] == "analog"
        self.hx = codes.build(cfg["code"])
        self.sigma = ref.sigma_from_rate(cfg["noise"]["q"])
        self.decoder = program.window_decoder(cfg, self.hx, self.sigma, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(inputs.stream_seed(seed, 1))
        self.pool = [histories(self.hx, cfg["rounds"], cfg["noise"]["p"], self.sigma,
                               traffic["batch"], gen, device) for _ in range(traffic["pool"])]
        self._references = {}

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.call(i)

    def call(self, i: int):
        """Call ``i``; returns ``(shots, (pool index, corrections,
        iterations))``."""
        k = i % len(self.pool)
        x, iterations = program.decode_to_host(self.decoder, *self.pool[k])
        return x.shape[0], (k, x, iterations)

    @staticmethod
    def keep(out):
        k, x, it = out
        return k, np.array(x, copy=True), np.array(it, copy=True)

    def free(self):
        """Drop the program's state before the reference runs."""
        self.decoder = None

    def _decoder(self, dtype=torch.float32):
        c, d, noise = self.cfg, self.cfg["decoder"], self.cfg["noise"]
        return ref.Decoder(self.hx, c["rounds"], c["window"], noise["p"], noise["q"], self.sigma,
                           d["max_iter"], d["ms_scaling_factor"], self.device,
                           d["last_round_rate"], dtype)

    def _reference(self, k: int):
        """The float32 reference's ``(corrections, iterations, work)`` of
        pool batch ``k``, each batch decoded once."""
        if k not in self._references:
            x, it, work = self._decoder().decode(*self.pool[k])
            self._references[k] = (x.cpu().numpy(), it.cpu().numpy(), work)
        return self._references[k]

    def judge(self, kept, control: bool = False) -> dict:
        """The compared numbers of the kept calls; with ``control`` the
        reference in bfloat16 stands in for the program.
        ``decodings_off_pct``: the checked shots whose correction differs
        in any bit; ``iterations_off``: those whose summed iterations
        differ; ``shots_off``: those with either."""
        want = [self._reference(k)[:2] for k, _, _ in kept]
        if control:
            bf16 = self._decoder(torch.bfloat16)
            got = [tuple(t.cpu().numpy() for t in bf16.decode(*self.pool[k])[:2])
                   for k, _, _ in kept]
        else:
            got = [(x, it) for _, x, it in kept]
        x_off = np.concatenate([np.any(g[0] != w[0], axis=1) for g, w in zip(got, want)])
        it_off = np.concatenate([g[1].astype(np.int64) != w[1] for g, w in zip(got, want)])
        return {"decodings_off_pct": 100.0 * float(x_off.mean()),
                "iterations_off": int(it_off.sum()), "shots_off": int((x_off | it_off).sum())}

    def failed(self, numbers: dict) -> int:
        """Checked shots whose correction or iterations differ from the
        reference's."""
        return numbers["shots_off"]

    def work(self, calls) -> dict:
        """The reference's work on the shots of the calls ``calls`` (the
        rooflines'), window by window: each distinct batch decoded once, its
        work counted as often as the calls ran it."""
        windows = None
        for k, c in Counter(i % len(self.pool) for i in calls).items():
            got = self._reference(k)[2]
            if windows is None:
                windows = [{key: 0 if key in COUNTS else v for key, v in w.items()} for w in got]
            for total, w in zip(windows, got):
                for key in COUNTS:
                    total[key] += c * w[key]
        return {"windows": windows or []}

    def sizes(self) -> dict:
        """The cell's rooflines take each window's sizes from ``work``."""
        return {}
