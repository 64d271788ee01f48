"""Device-resident Monte-Carlo decoding pipeline.

Port of ``ldpc_tpu.monte_carlo_simulation.device_mc``. One round runs, on
the device and with no host sync:

    uniform draws -> bernoulli errors -> syndromes (f32 matmul)
    -> phase-1 BP (K1') -> top-K compaction of the failed lanes
    -> full-depth BP (K1') + OSD-0 (K2') on that bucket -> merge
    -> logical check -> six int counters

A call runs ``rounds_per_call`` rounds in a Python loop and pulls one
(6,) counter vector. Errors come from ``torch.rand`` on an explicit
generator, seeded per call from ``(seed, call index)``, so a checkpointed
run resumes exactly.
"""

from typing import Dict

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.ops import osd as osd_ops


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return x - 2.0 * torch.floor(x * 0.5)


class McDecoderStep:
    """One Monte-Carlo call: ``step(generator) -> (6,) int64 counters``.

    Counters: [runs, decode_fails, bp_converged, bp_iters_total,
    osd_used, bucket_overflow]. ``decode_fails`` counts logical failures
    when ``logicals`` is given (lx @ residual != 0), else word errors
    (decoding != error). ``bucket_overflow`` counts phase-1 failures that
    did not fit the bucket of K lanes; they keep their phase-1 BP output.
    """

    def __init__(
        self,
        pcm,
        error_rate: float,
        *,
        logicals,
        batch_size: int,
        rounds_per_call: int,
        max_iter: int,
        bp_method: str,
        ms_scaling_factor: float,
        osd_method: str,
        bucket_fraction: int,
        phase1_iters,
        device,
    ):
        pcm = convert_to_binary_sparse(pcm)
        graph = compile_pcm(pcm)
        self.device = resolve_device(device)
        self.n = graph.n
        self.batch = _round_up(batch_size, 512)
        self.rounds_per_call = rounds_per_call
        self.K = min(
            self.batch, max(128, _round_up(self.batch // bucket_fraction, 128))
        )
        channel = np.full(graph.n, error_rate)
        self.init_llr = torch.from_numpy(bp_ops.channel_llr(channel)).to(
            self.device
        )
        self.p = torch.full(
            (graph.n,), error_rate, dtype=torch.float32, device=self.device
        )
        # the syndrome and logical products are 0/1 matmuls in f32; TF32
        # would keep them exact too, but the products are held to full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        self.Ht = torch.from_numpy(graph.dense.astype(np.float32).T).to(
            self.device
        )
        self.Lt = (
            torch.from_numpy(
                np.asarray(
                    convert_to_binary_sparse(logicals).todense(), np.float32
                ).T.copy()
            ).to(self.device)
            if logicals is not None
            else None
        )
        method = (
            bp_ops.MINIMUM_SUM
            if str(bp_method).lower() in ("ms", "min_sum", "minimum_sum", "1")
            else bp_ops.PRODUCT_SUM
        )
        self.run_osd = str(osd_method).lower() not in ("off", "osd_off", "-1")
        if phase1_iters is None:
            phase1_iters = min(max_iter, 6)
        self.two_phase = phase1_iters < max_iter
        self.bp1 = bp_ops.make_parallel_decoder(
            graph,
            method,
            phase1_iters if self.two_phase else max_iter,
            ms_scaling_factor,
            self.device,
        )
        self.bp2 = (
            bp_ops.make_parallel_decoder(
                graph, method, max_iter, ms_scaling_factor, self.device
            )
            if self.two_phase
            else None
        )
        self.osd = (
            osd_ops.make_osd_decoder(graph, channel, osd_ops.OSD_0, 0, self.device)
            if self.run_osd
            else None
        )

    def sample_errors(self, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(
            (self.batch, self.n), generator=generator, device=self.device
        )
        return (u < self.p[None, :]).to(torch.uint8)

    def decode_round(self, errors) -> torch.Tensor:
        """Decode one (B, n) batch of errors; returns the (6,) counters."""
        errors = torch.as_tensor(errors, dtype=torch.uint8, device=self.device)
        B = errors.shape[0]
        K = min(self.K, B)
        syn = _mod2(errors.to(torch.float32) @ self.Ht).to(torch.uint8)
        bp = self.bp1(syn, self.init_llr)
        conv, iters, decoding = bp.converged, bp.iterations, bp.decoding
        nfail_p1 = (~conv).sum()
        if self.two_phase or self.run_osd:
            # failed lanes first, then converged ones, each in lane order
            idx = torch.argsort(conv.to(torch.uint8), stable=True)[:K]
            syn_sub = syn[idx]
            if self.two_phase:
                bp2 = self.bp2(syn_sub, self.init_llr)
                sub_dec, sub_conv = bp2.decoding, bp2.converged
                sub_llr, sub_iters = bp2.llr_posterior, bp2.iterations
            else:
                sub_dec, sub_conv = decoding[idx], conv[idx]
                sub_llr, sub_iters = bp.llr_posterior[idx], iters[idx]
            if self.run_osd:
                x0, _, _ = self.osd(syn_sub, sub_llr)
                merged = torch.where(sub_conv[:, None], sub_dec, x0)
            else:
                merged = sub_dec
            decoding = decoding.index_put((idx,), merged)
            conv = conv.index_put((idx,), sub_conv)
            iters = iters.index_put((idx,), sub_iters)
        residual = errors ^ decoding
        if self.Lt is not None:
            lpar = _mod2(residual.to(torch.float32) @ self.Lt)
            fail = (lpar > 0.5).any(dim=1)
        else:
            fail = residual.any(dim=1)
        return torch.stack(
            [
                torch.tensor(B, device=self.device),
                fail.sum(),
                conv.sum(),
                iters.to(torch.int64).sum(),
                (~conv).sum(),
                torch.clamp(nfail_p1 - K, min=0),
            ]
        ).to(torch.int64)

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        acc = torch.zeros(6, dtype=torch.int64, device=self.device)
        for _ in range(self.rounds_per_call):
            acc = acc + self.decode_round(self.sample_errors(generator))
        return acc


def make_mc_decoder_step(
    pcm,
    error_rate: float,
    *,
    logicals=None,
    batch_size: int = 16384,
    rounds_per_call: int = 8,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_0",
    bucket_fraction: int = 8,
    phase1_iters=None,
    device="cuda",
):
    """Build a Monte-Carlo step ``fn(generator) -> counters`` on ``device``.

    Per call: ``rounds_per_call`` rounds of ``batch_size`` samples (rounded
    up to a multiple of 512). Two-phase BP: a short full-batch pass
    (``phase1_iters``, default ``min(max_iter, 6)``) filters the easy
    lanes; the first K = ``batch / bucket_fraction`` lanes in failed-first
    order re-run BP at full depth, then OSD-0. Per-lane BP is
    deterministic, so the counters equal a single-phase run unless the
    bucket overflows. Returns ``(step, runs_per_call)``; ``step`` also has
    ``decode_round(errors)`` for feeding given errors.
    """
    step = McDecoderStep(
        pcm,
        error_rate,
        logicals=logicals,
        batch_size=batch_size,
        rounds_per_call=rounds_per_call,
        max_iter=max_iter,
        bp_method=bp_method,
        ms_scaling_factor=ms_scaling_factor,
        osd_method=osd_method,
        bucket_fraction=bucket_fraction,
        phase1_iters=phase1_iters,
        device=device,
    )
    return step, step.batch * rounds_per_call


def call_seed(seed: int, call: int) -> int:
    """The generator seed of call ``call`` of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, call]).generate_state(1, np.uint64)[0])


class DeviceMonteCarlo:
    """Device-resident Monte-Carlo LER estimator with checkpointing.

    ``run(target_runs)`` decodes at least ``target_runs`` samples and
    returns the tallies; ``checkpoint()``/``restore()`` serialise the
    counters and the call index for an exact resume.
    """

    def __init__(self, pcm, error_rate: float, seed: int = 0, device="cuda", **kwargs):
        self.device = resolve_device(device)
        self._step, self.runs_per_call = make_mc_decoder_step(
            pcm, error_rate, device=self.device, **kwargs
        )
        self.seed = seed
        self.calls = 0
        self.counters = np.zeros(6, np.int64)

    def run(self, target_runs: int) -> Dict:
        while self.counters[0] < target_runs:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(call_seed(self.seed, self.calls))
            out = self._step(gen)
            self.calls += 1
            self.counters += out.cpu().numpy()
        runs, fails, conv, iters, osd_used, overflow = map(int, self.counters)
        return {
            "run_count": runs,
            "fail_count": fails,
            "logical_error_rate": fails / runs if runs else 0.0,
            "bp_converged": conv,
            "bp_iters_total": iters,
            "osd_used": osd_used,
            "bucket_overflow": overflow,
        }

    def checkpoint(self) -> Dict:
        return {
            "seed": self.seed,
            "calls": self.calls,
            "counters": self.counters.tolist(),
        }

    def restore(self, state: Dict) -> None:
        self.seed = int(state["seed"])
        self.calls = int(state["calls"])
        self.counters = np.asarray(state["counters"], np.int64)
