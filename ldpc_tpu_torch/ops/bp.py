"""Batched belief propagation (port of ``ldpc_tpu.ops.bp``).

Holds the method and schedule constants, the batch-major result type, the
channel LLRs and the decoder builders. The message passing itself lives in
the kernels' modules, each kernel on a CUDA device and its plain PyTorch
version on the CPU:

- :mod:`ldpc_tpu_torch.ops.bp_cuda`: K1', float32 parallel BP, and with a
  fixed factor the single-scan engine (float32 or float64);
- :mod:`ldpc_tpu_torch.ops.bp_fold`: K6' serial and serial-relative BP, K7'
  soft-information BP and K8' fold-exact float64 parallel BP.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops.pcm import PcmGraph

PRODUCT_SUM = 0
MINIMUM_SUM = 1

PARALLEL = 1
SERIAL = 0
SERIAL_RELATIVE = 2


class BpResult(NamedTuple):
    """Batched BP outputs, batch-major at the API boundary."""

    decoding: torch.Tensor  # (B, n) uint8
    llr_posterior: torch.Tensor  # (B, n) in the decoder's dtype
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int32


def channel_llr(error_channel: np.ndarray, dtype=np.float32) -> np.ndarray:
    """log((1-p)/p) per bit; p=0 gives +inf ("certainly not flipped")."""
    p = np.asarray(error_channel, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return (np.log((1.0 - p) / p)).astype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """A decoder's dtype as a torch dtype: float32 or float64, given as a
    torch or numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, not {dtype!r}")
    return getattr(torch, name)


def _tensors(device, dtype):
    """The batch-in, LLR-in conversion every builder's ``decode`` does."""

    def convert(batch, batch_dtype, init_llr):
        batch = torch.as_tensor(batch, dtype=batch_dtype, device=device).contiguous()
        init_llr = torch.as_tensor(init_llr, device=device).to(dtype).contiguous()
        return batch, init_llr

    return convert


def make_parallel_decoder(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    device,
    dtype=torch.float32,
):
    """Build a batched parallel-schedule BP decoder on ``device``.

    Returns ``decode(syndromes: (B, m) uint8, init_llr) -> BpResult``, with
    ``init_llr`` one (n,) prior for every lane or, in float32, a (B, n)
    prior, a row a lane (the analog-syndrome windows' per-shot priors, as
    the JAX package's fast engine takes them). Each lane stops at its first
    convergence; the decision, posterior and iteration count are those of
    that iteration (or of ``max_iter``). float32 runs K1' (the gather-only
    engine); float64 runs K8', the fold-exact engine the golden fixtures are
    replayed in, whose prior is (n,) only, as the JAX package's exact engine.
    """
    from ldpc_tpu_torch.ops import bp_cuda, bp_fold
    from ldpc_tpu_torch.ops.pcm import graph_to_torch

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    tg = graph_to_torch(graph, device)
    convert = _tensors(device, dtype)

    def decode(syndromes: torch.Tensor, init_llr: torch.Tensor) -> BpResult:
        syndromes, init_llr = convert(syndromes, torch.uint8, init_llr)
        if dtype == torch.float64 and init_llr.dim() != 1:
            raise ValueError("float64 parallel BP (K8') takes an (n,) prior only")
        engine = bp_cuda.bp_parallel if dtype == torch.float32 else bp_fold.bp_parallel_exact
        return engine(tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor)

    return decode


def make_single_scan_decoder(
    graph: PcmGraph,
    max_iter: int,
    ms_scaling_factor: float,
    device,
    dtype=torch.float32,
):
    """Min-sum "single-scan" BP: the parallel schedule's recurrence (the
    JAX package shares its engine, ``ldpc_tpu/ops/bp.py:135``), min-sum
    only, with the fixed ``ms_scaling_factor`` even at 0. Runs K1' with its
    dynamic factor off, in float32 or float64 (K1's float64 instance).

    Returns ``decode(syndromes: (B, m) uint8, init_llr: (n,)) -> BpResult``.
    """
    from ldpc_tpu_torch.ops import bp_cuda
    from ldpc_tpu_torch.ops.pcm import graph_to_torch

    device = resolve_device(device)
    tg = graph_to_torch(graph, device)
    convert = _tensors(device, torch_dtype(dtype))

    def decode(syndromes: torch.Tensor, init_llr: torch.Tensor) -> BpResult:
        syndromes, init_llr = convert(syndromes, torch.uint8, init_llr)
        return bp_cuda.bp_parallel(
            tg, syndromes, init_llr, MINIMUM_SUM, max_iter, ms_scaling_factor,
            dynamic_alpha=False,
        )

    return decode


def serial_order_table(
    n: int, max_iter: int, generator: torch.Generator, device
) -> torch.Tensor:
    """The random serial schedule: one permutation of the n bits for each
    iteration, (max_iter, n) int32 on ``device``, drawn by ``torch.randperm``
    from ``generator`` (which must live on ``device``'s type). It takes
    ``max_iter * n * 4`` bytes: 1.1 MB at surface d=13 and 30 iterations,
    207 MB for toric d=60 at max_iter = n."""
    rows = [torch.randperm(n, generator=generator, device=device) for _ in range(max_iter)]
    if not rows:
        return torch.zeros((0, n), dtype=torch.int32, device=device)
    return torch.stack(rows).to(torch.int32)


def schedule_generator(seed: int, device) -> torch.Generator:
    """A generator for the random serial schedule on ``device``, seeded from
    ``random_schedule_seed`` (0 means the clock, as in the JAX package)."""
    if seed == 0:
        seed = time.time_ns() & 0x7FFFFFFF
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def make_serial_decoder(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    device,
    schedule_mode: int = SERIAL,
    random_serial_schedule: bool = False,
    dtype=torch.float32,
):
    """Build a batched serial-schedule BP decoder on ``device`` (K6').

    Bits update one at a time, each reading the messages the bits before it
    wrote. Returns ``decode(syndromes: (B, m) uint8, init_llr: (n,),
    schedule: (n,) int, key) -> BpResult``. As in the JAX package
    ``schedule`` is ignored when ``random_serial_schedule`` (each iteration
    a permutation; ``key`` is a ``torch.Generator`` on ``device``'s type,
    see :func:`schedule_generator`, or an (>= max_iter, n) table of
    permutations, see :func:`serial_order_table`) or when ``schedule_mode``
    is SERIAL_RELATIVE (each lane's posteriors ranked most reliable first at
    the start of each iteration, equal ones in index order).
    """
    from ldpc_tpu_torch.ops import bp_fold
    from ldpc_tpu_torch.ops.pcm import graph_to_torch

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    tg = graph_to_torch(graph, device)
    convert = _tensors(device, dtype)
    n = graph.n
    on_card = device.type == "cuda"
    fixed_levels = {}  # the kernel's levels of each fixed order, by its bytes

    def decode(syndromes, init_llr, schedule=None, key=None) -> BpResult:
        syndromes, init_llr = convert(syndromes, torch.uint8, init_llr)
        levels = None
        if random_serial_schedule:
            mode = bp_fold.ORDER_TABLE
            order = key if isinstance(key, torch.Tensor) else serial_order_table(
                n, max_iter, key, device)
            order = order.to(device=device, dtype=torch.int32).contiguous()
            if on_card:
                levels = bp_fold.level_schedule(tg, order)
        elif schedule_mode == SERIAL_RELATIVE:
            mode, order = bp_fold.ORDER_RELATIVE, None
        else:
            mode = bp_fold.ORDER_FIXED
            host = np.arange(n, dtype=np.int32) if schedule is None else np.asarray(
                schedule.cpu() if isinstance(schedule, torch.Tensor) else schedule, np.int32)
            order = torch.from_numpy(np.ascontiguousarray(host)).to(device)
            if on_card:
                levels = fixed_levels.get(host.tobytes())
                if levels is None:
                    levels = fixed_levels[host.tobytes()] = bp_fold.level_schedule(tg, order)
        return bp_fold.bp_serial(
            tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor, order, mode,
            levels=levels,
        )

    return decode


def make_soft_info_decoder(
    graph: PcmGraph,
    max_iter: int,
    ms_scaling_factor: float,
    device,
    dtype=torch.float32,
):
    """Build a batched soft-syndrome serial min-sum BP decoder on
    ``device`` (K7', arXiv:2205.02341).

    Returns ``decode(soft_syndromes: (B, m), init_llr: (n,), cutoff, sigma)
    -> (BpResult, soft_syndrome_out: (B, m))``. The soft syndromes are cast
    to ``dtype`` and scaled by 2/sigma^2 (that factor rounded once to
    ``dtype``) before the sweep; the hard syndrome bit is ``soft <= 0``.
    """
    from ldpc_tpu_torch.ops import bp_fold
    from ldpc_tpu_torch.ops.pcm import graph_to_torch

    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    tg = graph_to_torch(graph, device)
    convert = _tensors(device, dtype)
    # the kernel's levels of index order, once per decoder
    levels = bp_fold.level_schedule(
        tg, torch.arange(graph.n, dtype=torch.int32, device=device)
    ) if device.type == "cuda" else None

    def decode(soft_syndromes, init_llr, cutoff: float, sigma: float):
        soft, init_llr = convert(soft_syndromes, dtype, init_llr)
        scale = torch.tensor(2.0 / (sigma * sigma), dtype=dtype, device=device)
        return bp_fold.bp_soft_info(
            tg, (soft * scale).contiguous(), init_llr, max_iter, ms_scaling_factor, cutoff,
            levels=levels,
        )

    return decode
