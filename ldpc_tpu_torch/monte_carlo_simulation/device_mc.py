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
run resumes exactly. The decodings of a call's rounds stay on the device
(``last_decodings``), so a caller can check them shot by shot.

On a CUDA device every shape of a round is fixed when the step is built
and nothing in it reads back to the host, so the step captures the round,
syndromes to counters, as one CUDA graph on its first call and replays it
on every round: the host launches a round's kernels in one graph launch
instead of one by one. The errors are still drawn eagerly, into the
graph's input, and each round's decodings are cloned out of it. On the CPU
the round runs eagerly.

With the recorder of :mod:`ldpc_tpu_torch.utils.profiling` on,
``DeviceMonteCarlo.run`` is the span ``mc.run`` (counters ``mc.calls``,
``mc.shots``) over an ``mc.round`` a round (``mc.rounds``) and a
``sync.mc_counters`` a call, the pull of the counters; from the pulled
vector it counts ``mc.lanes.bucket`` (K a round), ``mc.lanes.osd`` and
``mc.bucket_overflow``. On a CUDA device it counts ``mc.graph.captures``
(one a step) and ``mc.graph.replays`` (one a round), and each replay
counts the kernel launches the graph holds, as the eager round would; the
spans inside a round (``osd``) are not recorded under a replay.

:func:`make_sharded_mc_step` runs the step on every entry of a mesh's
batch axis, each on its own generator, and sums the counters (in the
process, then over the processes).
"""

import contextlib
from typing import Dict

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.ops import osd as osd_ops
from ldpc_tpu_torch.utils.profiling import count, span, sync, tally


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

    ``last_decodings`` is the list of the last call's (B, n) uint8
    decodings, one a round in round order, as each round's merge left them
    on the device; each call replaces it, and a later call leaves an
    earlier call's tensors as they were. On the CPU keeping them adds no
    kernel, copy or host sync; on a CUDA device each is one device copy out
    of the captured round's output.

    On a CUDA device a call replays one captured round
    (:meth:`_capture`); ``decode_round`` runs eagerly on any device.
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
        self.last_decodings = []
        # on a CUDA device: the captured round (on the first call) and its input
        self._graph = None
        if self.device.type == "cuda":
            self._errors = torch.empty(
                (self.batch, self.n), dtype=torch.uint8, device=self.device)

    def sample_errors(self, generator: torch.Generator, out=None) -> torch.Tensor:
        """One round's (B, n) uint8 errors drawn from ``generator``, written
        into ``out`` where it is given."""
        u = torch.rand(
            (self.batch, self.n), generator=generator, device=self.device
        )
        if out is not None:
            return torch.lt(u, self.p, out=out)
        return (u < self.p[None, :]).to(torch.uint8)

    def decode_round(self, errors) -> torch.Tensor:
        """Decode one (B, n) batch of errors; returns the (6,) counters."""
        return self._round(errors)[0]

    def _round(self, errors):
        """The (6,) counters of one (B, n) batch of errors and its (B, n)
        uint8 decodings."""
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
        counters = torch.stack(
            [
                torch.full((), B, dtype=torch.int64, device=self.device),
                fail.sum(),
                conv.sum(),
                iters.to(torch.int64).sum(),
                (~conv).sum(),
                torch.clamp(nfail_p1 - K, min=0),
            ]
        ).to(torch.int64)
        return counters, decoding

    def _capture(self) -> None:
        """Capture one round on the errors in ``self._errors`` as a CUDA
        graph, after an eager warm-up round on a side stream (PyTorch's
        recipe). The capture runs nothing; the recorder keeps the launches
        it would make, which each replay counts."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._round(self._errors)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with tally() as counts, torch.cuda.graph(
            graph, stream=side, capture_error_mode="thread_local"
        ):
            self._counters, self._decodings = self._round(self._errors)
        self._graph, self._graph_counts = graph, counts
        count("mc.graph.captures")

    def _replayed_round(self, generator: torch.Generator):
        """A round on a CUDA device: its errors drawn into the captured
        round's input, the graph replayed (captured on the first round), its
        decodings cloned out of the graph's memory."""
        self.sample_errors(generator, out=self._errors)
        if self._graph is None:
            self._capture()
        self._graph.replay()
        count("mc.graph.replays")
        for name, k in self._graph_counts.items():
            count(name, k)
        return self._counters, self._decodings.clone()

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        cuda = self.device.type == "cuda"
        acc = torch.zeros(6, dtype=torch.int64, device=self.device)
        self.last_decodings = decodings = []
        with torch.cuda.device(self.device) if cuda else contextlib.nullcontext():
            for _ in range(self.rounds_per_call):
                count("mc.rounds")
                with span("mc.round"):
                    if cuda:
                        counters, decoding = self._replayed_round(generator)
                    else:
                        counters, decoding = self._round(self.sample_errors(generator))
                    acc = acc + counters
                    decodings.append(decoding)
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


class ShardedStep:
    """A step run on every entry of a mesh axis: ``step(generator)`` -> the
    counters of every entry's local step, summed.

    Entry ``i`` (global index ``process_index() * D + i``) draws from its
    own generator, on its own device, seeded by :func:`call_seed` from one
    key drawn from the call's generator and the entry's global index — as
    the JAX package splits the call's key into one key an entry. Every
    process draws the same key from an identically seeded generator, so
    the processes' entries take distinct streams. The counters are summed
    over the entries in entry order (:func:`~ldpc_tpu_torch.parallel.
    sharding.psum`), then all-reduced over the processes; they land on the
    first entry's device. ``local`` maps each distinct device of the axis
    to its local step.
    """

    def __init__(self, devices, local):
        self.devices = list(devices)
        self.local = local

    def generators(self, generator: torch.Generator) -> list:
        """The entries' generators of a call drawing from ``generator``."""
        from ldpc_tpu_torch.parallel.distributed import process_index

        key = int(torch.randint(2**62, (1,), generator=generator, device=generator.device))
        first = process_index() * len(self.devices)
        gens = []
        for i, dev in enumerate(self.devices):
            gen = torch.Generator(device=dev)
            gen.manual_seed(call_seed(key, first + i))
            gens.append(gen)
        return gens

    def run(self, generators) -> torch.Tensor:
        """The summed counters of every entry's step on ``generators``."""
        from ldpc_tpu_torch.parallel.distributed import all_reduce
        from ldpc_tpu_torch.parallel.sharding import psum, run_entries

        counters = run_entries(
            self.devices, lambda i: self.local[self.devices[i]](generators[i]))
        return all_reduce(psum(counters, self.devices)[0])

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        return self.run(self.generators(generator))


def make_sharded_step(make_local, mesh, batch_size_per_device: int, kwargs):
    """``(ShardedStep, runs a call)`` over the mesh's batch axis (or its
    first axis), with ``make_local(batch_size=..., device=..., **kwargs)``
    building the local step of each distinct device."""
    from ldpc_tpu_torch.parallel.distributed import process_count
    from ldpc_tpu_torch.parallel.sharding import BATCH_AXIS, make_mesh

    if "device" in kwargs:
        raise TypeError("a sharded step runs on its mesh's devices; pass mesh=, not device=")
    if mesh is None:
        mesh = make_mesh()
    axis = BATCH_AXIS if BATCH_AXIS in mesh.axis_names else mesh.axis_names[0]
    devices = mesh.axis_devices(axis)
    local = {}
    for dev in dict.fromkeys(devices):
        local[dev], runs_local = make_local(
            batch_size=batch_size_per_device, device=dev, **kwargs)
    return ShardedStep(devices, local), runs_local * len(devices) * process_count()


def make_sharded_mc_step(
    pcm,
    error_rate: float,
    *,
    mesh=None,
    batch_size_per_device: int = 16384,
    **kwargs,
):
    """Multi-device Monte-Carlo step: data-parallel over the mesh's
    ``batch`` axis (every visible card by default). Every entry runs the
    whole device pipeline (:class:`McDecoderStep`) on its own generator and
    the counters are summed (:class:`ShardedStep`).

    Returns ``(step, runs_per_call)`` where ``step(generator)`` -> (6,)
    int64 counters, ``runs_per_call`` counting every entry of every process
    (build after :func:`~ldpc_tpu_torch.parallel.initialize_distributed`).
    ``kwargs`` are :func:`make_mc_decoder_step`'s.
    """

    def make_local(**kw):
        return make_mc_decoder_step(pcm, error_rate, **kw)

    return make_sharded_step(make_local, mesh, batch_size_per_device, kwargs)


class DeviceMonteCarlo:
    """Device-resident Monte-Carlo LER estimator with checkpointing.

    ``run(target_runs)`` decodes at least ``target_runs`` samples and
    returns the tallies; ``checkpoint()``/``restore()`` serialise the
    counters and the call index for an exact resume.

    After a call, ``last_call`` is its index (the ``call`` of
    :func:`call_seed` that seeded its errors), ``last_counters`` its (6,)
    counters on the host and ``last_decodings`` its decodings on the
    device (:class:`McDecoderStep`); before the first, ``None``, ``None``
    and ``[]``.
    """

    def __init__(self, pcm, error_rate: float, seed: int = 0, device="cuda", **kwargs):
        self.device = resolve_device(device)
        self._step, self.runs_per_call = make_mc_decoder_step(
            pcm, error_rate, device=self.device, **kwargs
        )
        self.seed = seed
        self.calls = 0
        self.counters = np.zeros(6, np.int64)
        self.last_call = None
        self.last_counters = None

    @property
    def last_decodings(self) -> list:
        """The last call's (B, n) uint8 decodings, one a round."""
        return self._step.last_decodings

    def run(self, target_runs: int) -> Dict:
        with span("mc.run"):
            while self.counters[0] < target_runs:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(call_seed(self.seed, self.calls))
                out = self._step(gen)
                with sync("mc_counters"):
                    host = out.cpu().numpy()
                self.last_call, self.last_counters = self.calls, host
                self.calls += 1
                self.counters += host
                count("mc.calls")
                count("mc.shots", host[0])
                count("mc.lanes.bucket", self._step.K * self._step.rounds_per_call)
                count("mc.lanes.osd", host[4])
                count("mc.bucket_overflow", host[5])
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
