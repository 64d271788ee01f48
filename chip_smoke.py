"""Drive the PyTorch/CUDA port (``ldpc_tpu_torch``) once on one NVIDIA GPU.

Usage: ``python chip_smoke.py`` from the repository root, on a machine with
a CUDA device, ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``) and
PyTorch built for CUDA. It builds the kernels from ``ldpc_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card and times
both, drives ``decode_batch`` of BP+OSD-0, BP+OSD-CS (order 5), BP+LSD-0,
BP+LSD-CS (order 5) and the device Monte-Carlo step at the d=13
surface-code workload, then the flip sweep against its plain version and
``decode_batch`` of BeliefFind (inversion and peeling), standalone
union-find (matrix and peeling), standalone LSD (order 0 and CS-5), flip
and BP+flip on the same syndromes, and one BP+LSD statistics record on the
card against the CPU's. K1' (BP) is held against its plain version with
its lane state in shared memory and in device memory, and timed at both of
the main path's launch shapes. K2'-K5' are held against their plain
versions in each variant (warp per lane, block per lane, and the block body
on a matrix in device memory, each forced) and timed in each: K2', K3' and
K5' at their main-path calls (K2' also at a Monte-Carlo bucket, with the
columns its lanes walk), K4' summed over every call of the LSD-0 path and of
the standalone UnionFind path (65,536 lanes), K3'-K5' on surface d=17 and
toric d=20 too. The ``large_code`` phase takes toric d=31, whose lane does
not fit a block's shared memory: K2'-K5' by default (the device variant)
against their plain versions, then ``decode_batch`` of BP+OSD-0,
BP+OSD-CS-5, BP+LSD-0 and UnionFind on the card against the CPU path. K9'
(MBP over GF(4)) is held against its plain version in float64 and float32
and timed on the MBP workload (Hgf4 = [3 hz; hx] of the d=13 surface code,
16,384 depolarizing syndromes), K1''s float64 instance (single-scan) the
same way; then ``MbpDecoder.decode_batch`` on that workload,
``uf_decode`` on CSS syndromes, single-scan in float64, and the float64
decoders (BP+LSD-0, BP+LSD-CS-5, BeliefFind, BP+flip) run their main
paths, each against the CPU path. Every
``*_time`` phase prints
the kernel's device time (``device_ms``), its plain version's and its
bound (see ``bound``). Every phase prints
one line; any failure raises and exits non-zero. The second-to-last line
is a JSON object describing each kernel; the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits 1.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

import ldpc_tpu_torch
from ldpc_tpu_torch.codes import surface_code, toric_code
from ldpc_tpu_torch.decoders import mbp_decoder as mbp_decoder_mod
from ldpc_tpu_torch.monte_carlo_simulation import make_mc_decoder_step
from ldpc_tpu_torch.ops import (
    _build, bp_cuda, bp_fold, flip, gf2, gf2_cuda, lsd, mbp, mbp_cuda, osd, uf)
from ldpc_tpu_torch.ops.bp import (
    MINIMUM_SUM, PRODUCT_SUM, BpResult, channel_llr, serial_order_table)
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch

DISTANCE = 13
ERROR_RATE = 0.01
MAX_ITER = 30
PHASE1_ITERS = 6  # the cascade's first BP launch (BpDecoderBase._CASCADE_ITERS)
MS_FACTOR = 0.625
BATCH = 65536  # the host-boundary workload (numpy seed 7)
KERNEL_BATCH = 8192  # kernel-vs-plain comparisons
CPU_ROWS = 4096  # rows also decoded on the CPU and compared
TIMED_ROUNDS = 7
SLICE_B_ROUNDS = 3  # timed decode_batch calls of each slice-B configuration
SLICE_C_ROUNDS = 3  # ... of each slice-C configuration
PFLIP_SWEEPS = 20  # flip sweeps of the p-flip comparisons (the plain version
# takes every sweep of a lane that never converges)
STATS_ROWS = 256  # rows decoded by the statistics phase
LARGE_DISTANCE = 31  # toric code of the large_code phase (m=961, n=1922)
LARGE_ERROR_RATE = 0.03  # ... at which BP leaves lanes to the post-processors
LARGE_ROWS = 400  # syndromes its decoders take
LARGE_CPU_ROWS = 32  # ... of which the CPU path decodes the first
MC_BATCH = 16384
MC_ROUNDS = 8
MC_CALLS = 3
SOFT_NOISE = 0.3  # soft syndromes (1 - 2 s) + SOFT_NOISE * N(0, 1), numpy seed 7
SOFT_SIGMA = 0.3
SOFT_CUTOFF = 10.0
FOLD_LARGE_DISTANCE = 60  # toric code of the fold engines' device-state check
FOLD_LARGE_ROWS = 16
FOLD_LARGE_ITERS = 3  # ... at this depth: its plain version takes n steps a sweep
GOLDEN = "tests/fixtures/bp_golden.npz"  # the reference C++ decoder's BP decodings
# MBP: the repo's own MBP workload (tools/decoder_bench.py): Hgf4 = [3 hz; hx]
# of the d=13 surface code, each Pauli at MBP_ERROR_RATE, min-sum with
# gamma = MS_FACTOR, alpha 1, beta 0, MAX_ITER iterations
MBP_BATCH = 16384
MBP_ERROR_RATE = 0.01
MBP_CPU_ROWS = 1024  # rows also decoded on the CPU and compared
UF_DECODE_ROWS = 64  # CSS syndromes of the uf_decode check
SINGLE_SCAN_ROWS = 64  # syndromes decoded one at a time by decode_single_scan


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn()``: ``calls`` back-to-back calls captured in
    one CUDA graph, replayed ``replays`` times after a warm-up replay and
    timed by CUDA events. The host's work per call (argument checks, the
    launch through ctypes), which :func:`cuda_ms` includes whenever it
    outlasts the kernel, is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


# The least time the card could take (NVIDIA's H100 SXM data sheet): bytes
# over the HBM rate, operations over the rate of their type outside the
# tensor cores counted per operation. float32: 67 TFLOP/s counts an FMA as
# two, so 33.5e12 operations/s; the float32 kernels' integer and compare
# operations are counted at that rate too, so the time is a floor. float64
# (K8', and every call timed in float64): 34 TFLOP/s, so 17e12 operations/s,
# its float64 adds, products and compares counted at it; its integer and
# bit operations at INT_OPS_PER_S on their own pipe (NVIDIA's H100
# architecture whitepaper: an SM has 64 INT32 units beside its 128 FP32
# units, so half the float32 rate), the larger of the two times counted.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
F64_OPS_PER_S = 17e12
INT_OPS_PER_S = OPS_PER_S / 2


def nbytes(*tensors) -> int:
    """Bytes of ``tensors``, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, ops_per_s: float = OPS_PER_S):
    """``(bound_ms, bound_by)``: the larger of the two floors, and which;
    operations at ``ops_per_s`` (:data:`OPS_PER_S` float32,
    :data:`F64_OPS_PER_S` float64, :data:`INT_OPS_PER_S` integer)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_ops(graph, lane_iterations: int) -> float:
    """Min-sum operations of K1' over ``lane_iterations``: per edge 7 in
    the check update (subtract, abs, two min compares, sign test, scale,
    sign select), 1 in the bit sum and 1 in the syndrome test; per bit the
    hard-decision compare."""
    return float(lane_iterations) * (9 * graph.nnz + graph.n)


def gf2_ops(tg, steps: int, pivot_words: int) -> float:
    """GF(2) elimination operations: each column step tests the column bit
    of the m rows; each pivot reads its row's words (``pivot_words`` in
    all). A floor: the XORs into the rows holding a 1 are not counted."""
    return float(steps) * tg.m + float(pivot_words)


def timed(name, shape, kernel, plain, bytes_moved, ops, reps=5, plain_reps=2, **extra):
    """Time ``kernel`` (device time, :func:`device_ms`; and ``call_ms``, the
    eager call as :func:`cuda_ms` times it) and ``plain`` on the card and
    print them beside the bound; returns the numbers the kernels line
    carries."""
    ms = device_ms(kernel)
    call_ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps)
    bound_ms, bound_by = bound(bytes_moved, ops)
    phase(name, shape=shape, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
          bound_by=bound_by, share_of_bound=bound_ms / ms, **extra)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def workload(H: np.ndarray, rows: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    errors = (rng.random((rows, H.shape[1])) < ERROR_RATE).astype(np.uint8)
    return errors, (errors @ H.T % 2).astype(np.uint8)


def main_workload():
    """The d=13 surface code, its dense H and the BATCH syndromes every
    ``decode_batch`` configuration decodes."""
    code = surface_code(DISTANCE, compute_logicals=True)
    H = np.asarray(code.hx.todense(), np.uint8)
    return code, H, workload(H, BATCH)[1]


def soft_syndromes(syn: np.ndarray) -> np.ndarray:
    """Soft syndromes of the hard ones: (1 - 2 s) + SOFT_NOISE * N(0, 1),
    numpy seed 7."""
    rng = np.random.default_rng(7)
    return (1 - 2 * syn.astype(np.float64)) + SOFT_NOISE * rng.standard_normal(syn.shape)


@dataclasses.dataclass(frozen=True)
class DecodePath:
    """One ``decode_batch`` configuration: ``make(device)`` builds the
    decoder, ``decode_batch(syndromes, *args)`` runs it; ``kernels`` are
    the launch counters that must move, ``solves`` the rows H x = s is
    checked on (see :func:`drive_decoder`), ``rounds`` the timed calls;
    ``inputs`` maps the hard syndromes to what ``decode_batch`` takes
    (None: the syndromes themselves)."""

    key: str
    label: str
    make: Callable[[str], object]
    kernels: tuple
    rounds: int
    args: tuple = ()
    solves: str = "all"
    inputs: Callable = None


def decode_paths(code) -> list:
    """Every ``decode_batch`` configuration driven on the d=13 workload, in
    the order this script drives them (``tools/profile_torch.py`` profiles
    the same list)."""
    hx, n = code.hx, code.hx.shape[1]
    bp = dict(error_rate=ERROR_RATE, max_iter=MAX_ITER, bp_method="minimum_sum",
              ms_scaling_factor=MS_FACTOR)
    llr1 = np.full(n, np.log((1 - ERROR_RATE) / ERROR_RATE), np.float32)
    T, P = ldpc_tpu_torch, DecodePath
    B_ROUNDS, C_ROUNDS = SLICE_B_ROUNDS, SLICE_C_ROUNDS
    return [
        P("osd0", "osd_0", lambda d: T.BpOsdDecoder(hx, osd_method="osd_0", device=d, **bp),
          ("bp_parallel", "osd0"), TIMED_ROUNDS),
        P("osd_cs5", "osd_cs-5", lambda d: T.BpOsdDecoder(
            hx, osd_method="osd_cs", osd_order=5, device=d, **bp),
          ("bp_parallel", "rref_export"), B_ROUNDS),
        P("lsd0", "lsd0", lambda d: T.BpLsdDecoder(hx, lsd_method="lsd_0", device=d, **bp),
          ("bp_parallel", "masked_solve"), B_ROUNDS),
        P("lsd_cs5", "lsd_cs-5", lambda d: T.BpLsdDecoder(
            hx, lsd_method="lsd_cs", lsd_order=5, device=d, **bp),
          ("bp_parallel", "masked_solve", "masked_export"), B_ROUNDS),
        *(P(f"bf_{m}", f"BeliefFindDecoder[{m}]", lambda d, m=m: T.BeliefFindDecoder(
            hx, uf_method=m, device=d, **bp), ("bp_parallel", "masked_solve"), C_ROUNDS)
          for m in ("inversion", "peeling")),
        *(P(f"uf_{name}", f"UnionFindDecoder[{name}]", lambda d, mm=matrix: T.UnionFindDecoder(
            hx, uf_method=mm, device=d), ("masked_solve",), C_ROUNDS, solves="valid")
          for name, matrix in (("matrix", True), ("peeling", False))),
        P("lsd0_standalone", "LsdDecoder[standalone-lsd0]", lambda d: T.LsdDecoder(
            hx, lsd_method="lsd_0", lsd_order=0, device=d),
          ("masked_solve",), C_ROUNDS, args=(llr1,), solves="valid"),
        P("lsd_cs5_standalone", "LsdDecoder[standalone-lsd_cs-5]", lambda d: T.LsdDecoder(
            hx, lsd_method="lsd_cs", lsd_order=5, device=d),
          ("masked_solve", "masked_export"), C_ROUNDS, args=(llr1,), solves="valid"),
        P("flip", "FlipDecoder", lambda d: T.FlipDecoder(hx, max_iter=n, device=d),
          ("flip",), C_ROUNDS, solves="converged"),
        P("bp_flip", "BpFlipDecoder", lambda d: T.BpFlipDecoder(
            hx, flip_iterations=0, device=d, **bp),
          ("flip", "bp_parallel"), C_ROUNDS, solves="converged"),
        *(P(f"osd0_{sched}", f"osd_0[{sched}]", lambda d, sched=sched: T.BpOsdDecoder(
            hx, osd_method="osd_0", schedule=sched, device=d, **bp),
          ("bp_serial", "osd0"), B_ROUNDS) for sched in ("serial", "serial_relative")),
        P("osd0_f64", "osd_0[float64]", lambda d: T.BpOsdDecoder(
            hx, osd_method="osd_0", dtype="float64", device=d, **bp),
          ("bp_parallel_exact", "osd0"), B_ROUNDS),
        P("soft_osd0", "SoftInfoBpOsdDecoder[osd_0]", lambda d: T.SoftInfoBpOsdDecoder(
            hx, error_rate=ERROR_RATE, max_iter=MAX_ITER, ms_scaling_factor=MS_FACTOR,
            osd_method="osd_0", cutoff=SOFT_CUTOFF, sigma=SOFT_SIGMA, device=d),
          ("bp_soft_info", "osd0"), B_ROUNDS, solves="soft", inputs=soft_syndromes),
        # float64: K8' at full depth (no cascade), then the post-processor
        P("lsd0_f64", "lsd0[float64]", lambda d: T.BpLsdDecoder(
            hx, lsd_method="lsd_0", dtype="float64", device=d, **bp),
          ("bp_parallel_exact", "masked_solve"), B_ROUNDS),
        P("lsd_cs5_f64", "lsd_cs-5[float64]", lambda d: T.BpLsdDecoder(
            hx, lsd_method="lsd_cs", lsd_order=5, dtype="float64", device=d, **bp),
          ("bp_parallel_exact", "masked_solve", "masked_export"), B_ROUNDS),
        P("bf_inversion_f64", "BeliefFindDecoder[inversion,float64]",
          lambda d: T.BeliefFindDecoder(hx, uf_method="inversion", dtype="float64", device=d,
                                        **bp),
          ("bp_parallel_exact", "masked_solve"), C_ROUNDS),
        P("bp_flip_f64", "BpFlipDecoder[float64]", lambda d: T.BpFlipDecoder(
            hx, flip_iterations=0, dtype="float64", device=d, **bp),
          ("flip", "bp_parallel_exact"), C_ROUNDS, solves="converged"),
    ]


def large_paths(hx) -> list:
    """The ``decode_batch`` configurations of the ``large_code`` phase, on a
    code whose lane does not fit a block's shared memory: each must reach
    its GF(2) kernel in the device variant."""
    bp = dict(error_rate=LARGE_ERROR_RATE, max_iter=MAX_ITER, bp_method="minimum_sum",
              ms_scaling_factor=MS_FACTOR)
    T, P = ldpc_tpu_torch, DecodePath
    return [
        P("osd0", "large/osd_0", lambda d: T.BpOsdDecoder(hx, osd_method="osd_0", device=d, **bp),
          ("bp_device_state", "osd0_device"), 1),
        P("osd_cs5", "large/osd_cs-5", lambda d: T.BpOsdDecoder(
            hx, osd_method="osd_cs", osd_order=5, device=d, **bp),
          ("bp_device_state", "rref_export_device"), 1),
        P("lsd0", "large/lsd0", lambda d: T.BpLsdDecoder(hx, lsd_method="lsd_0", device=d, **bp),
          ("bp_device_state", "masked_solve_device"), 1),
        P("uf_matrix", "large/UnionFindDecoder[matrix]", lambda d: T.UnionFindDecoder(
            hx, uf_method=True, device=d), ("masked_solve_device",), 1, solves="valid"),
    ]


def mbp_workload(rows=MBP_BATCH, seed=7):
    """The d=13 surface code as Hgf4 = [3 hz; hx] (312 x 313), its hx and
    hz, and ``rows`` depolarizing syndromes: each qubit X, Y or Z with
    probability MBP_ERROR_RATE each (numpy seed ``seed``)."""
    code = surface_code(DISTANCE)
    hx, hz = (np.asarray(h.todense(), np.uint8) for h in (code.hx, code.hz))
    H = np.vstack([3 * hz, hx]).astype(np.uint8)
    p = MBP_ERROR_RATE
    rng = np.random.default_rng(seed)
    errors = rng.choice(4, size=(rows, H.shape[1]), p=[1 - 3 * p, p, p, p]).astype(np.uint8)
    return H, hx, hz, mbp.pauli_syndrome(H, errors).astype(np.uint8)


def make_mbp_decoder(H, device):
    """``MbpDecoder`` at the MBP workload's settings."""
    return ldpc_tpu_torch.MbpDecoder(
        Hgf4=H, error_channel=np.full((3, H.shape[1]), MBP_ERROR_RATE), max_iter=MAX_ITER,
        alpha_parameter=1.0, beta_parameter=0.0, bp_method="min_sum",
        gamma_parameter=MS_FACTOR, device=device)


def mc_step(code, device):
    """The device Monte-Carlo step at the d=13 workload: ``(step,
    runs_per_call)``."""
    return make_mc_decoder_step(
        code.hx, ERROR_RATE, logicals=code.lx, batch_size=MC_BATCH,
        rounds_per_call=MC_ROUNDS, max_iter=MAX_ITER,
        ms_scaling_factor=MS_FACTOR, device=device,
    )


def compare_bp(name, tg, syn, llr0, method, alpha, max_iter=MAX_ITER, states=(None, "device")):
    """K1' against its plain version on the same inputs, once for each of
    ``states``: where a lane's state lives, forced, or chosen by the
    footprint when None. Min-sum must be bit-identical (decisions,
    posteriors, flags, iterations), product-sum within rtol 1e-4. Returns
    the first state's result and the largest |kernel - plain| posterior
    difference."""
    ref = bp_cuda.bp_parallel_reference(tg, syn, llr0, method, max_iter, alpha)
    first, worst = None, 0.0
    for state in states:
        ker = bp_cuda.bp_parallel_cuda(tg, syn, llr0, method, max_iter, alpha, state=state)
        torch.cuda.synchronize()
        lane_diff = (
            (ker.decoding != ref.decoding).any(dim=1)
            | (ker.converged != ref.converged)
            | (ker.iterations != ref.iterations)
        )
        nlanes = int(lane_diff.sum())
        err = float((ker.llr_posterior - ref.llr_posterior).abs().max()) if syn.shape[0] else 0.0
        phase(
            "k1_device_vs_plain" if state == "device" else "k1_vs_plain",
            config=name, state=state or bp_cuda.state_variant(tg.m, tg.n, tg.dc),
            lanes=syn.shape[0], max_iter=max_iter, differing_lanes=nlanes,
            max_abs_err=err, converged=int(ker.converged.sum()),
        )
        if method == MINIMUM_SUM:
            # same operations in the same order on both sides: bit-exact
            if nlanes or err != 0.0:
                raise AssertionError(f"K1' min-sum differs from its plain version: {name}")
        elif not torch.allclose(ker.llr_posterior, ref.llr_posterior, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"K1' product-sum posteriors beyond rtol 1e-4: {name}")
        first = ker if first is None else first
        worst = max(worst, err)
    return first, worst


# K2'-K5' variants compared and timed: a warp per lane, a block per lane,
# and the block body on a matrix in device memory
ELIM_VARIANTS = gf2_cuda.VARIANTS


def run_variant(kname, variant, *args):
    """One K2'-K5' launch in ``variant`` (None: the one the library chooses
    for the code); the variant's counter must move, by one unless the device
    variant runs the batch in chunks."""
    tgx = args[0]
    counted = variant or gf2_cuda.elim_variant(kname, tgx.m, tgx.n)
    before = gf2_cuda.VARIANT_LAUNCHES[kname][counted]
    out = getattr(gf2_cuda, f"{kname}_cuda")(*args, variant=variant)
    torch.cuda.synchronize()
    moved = gf2_cuda.VARIANT_LAUNCHES[kname][counted] - before
    if moved < 1 or (moved > 1 and counted != "device"):
        raise AssertionError(f"{kname}: the {counted} variant's counter moved by {moved}")
    return out


def compare_osd(name, tg, H, syn, llr, rank, variants=ELIM_VARIANTS):
    """K2' against its plain version in every variant of ``variants``
    (forced; None: the default), and the plain model of its warp variant
    against the plain version."""
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()
    ref = gf2_cuda.osd0_reference(tg, syn, order, rank)
    if int(_lanes_differ(gf2_cuda.osd0_compact_reference(tg, syn, order, rank), ref).sum()):
        raise AssertionError(f"K2's compact model differs from the plain version: {name}")
    s = syn.cpu().numpy()
    worst = 0
    for variant in variants:
        ker = run_variant("osd0", variant, tg, syn, order, rank)
        nlanes, err = int(_lanes_differ(ker, ref).sum()), _max_abs_err(ker, ref)
        x, valid = ker[0].cpu().numpy(), ker[1].cpu().numpy()
        solves = ((x @ H.T) % 2 == s).all(axis=1)
        phase(
            "k2_vs_plain", config=name,
            variant=variant or gf2_cuda.elim_variant("osd0", tg.m, tg.n),
            lanes=syn.shape[0], differing_lanes=nlanes, max_abs_err=err,
            valid=int(valid.sum()), solves_on_valid=bool(solves[valid].all()),
        )
        if nlanes or err:
            raise AssertionError(f"K2' differs from its plain version: {name}/{variant}")
        if not solves[valid].all():
            raise AssertionError(f"K2' x0 does not solve H x = s on a valid lane: {name}")
        worst = max(worst, err)
    return worst


def _lanes_differ(ker, ref) -> torch.Tensor:
    """Lanes on which any output of a GF(2) kernel differs from its plain
    version's: (B,) bool."""
    diff = torch.zeros(ker[0].shape[0], dtype=torch.bool, device=ker[0].device)
    for a, b in zip(ker, ref):
        diff |= (a != b).reshape(a.shape[0], -1).any(dim=1)
    return diff


def _max_abs_err(ker, ref) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(ker, ref))


EDGE_LANES = 1024  # lanes of the count-edge case


def compare_elim(name, tg, graph, syn, llr, variants=ELIM_VARIANTS):
    """K3', K4' and K5' against their plain versions in every variant of
    ``variants`` (forced, or the default where None; each launch must move
    its variant's counter): K3'
    on the lanes' reliability orders; K4' and K5' on the clusters after a
    real first growth round, with a random count 0..n per lane, and with
    counts at the edges of K4's one-word rows (0, 1, 31, 32, 33, 63, 64, n)
    on the first EDGE_LANES lanes. Returns the largest |kernel - plain| of
    each kernel's outputs."""
    n = graph.n
    rank = gf2.batched_rank(graph.dense)
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()
    err = {"rref_export": 0, "masked_solve": 0, "masked_export": 0}
    run = run_variant

    def named(kname, variant):
        return variant or gf2_cuda.elim_variant(kname, tg.m, tg.n)

    ref = gf2_cuda.rref_export_reference(tg, syn, order, rank)
    for variant in variants:
        ker = run("rref_export", variant, tg, syn, order, rank)
        nlanes = int(_lanes_differ(ker, ref).sum())
        e = _max_abs_err(ker, ref)
        full_rank = bool((ker[2].sum(dim=1) == rank).all())
        phase("k3_vs_plain", config=name, variant=named("rref_export", variant),
              lanes=syn.shape[0],
              differing_lanes=nlanes, max_abs_err=e, full_rank=full_rank)
        if nlanes or e or not full_rank:
            raise AssertionError(f"K3' differs from its plain version: {name}/{variant}")
        err["rref_export"] = max(err["rref_export"], e)

    # a real first growth round: every cluster empty, then one grow_round
    empty = torch.zeros(syn.shape[0], dtype=torch.int32, device=syn.device)
    _, bad = gf2_cuda.masked_solve_reference(tg, syn, order, empty)
    in_bit, _ = uf.grow_round(tg, torch.zeros_like(llr, dtype=torch.bool), bad,
                              uf.llr_rank(llr), 1)
    key = torch.where(in_bit, llr, torch.inf)
    grown = torch.argsort(key, dim=1, stable=True).to(torch.int32).contiguous()
    rng = np.random.default_rng(5)
    random = torch.from_numpy(rng.integers(0, n + 1, syn.shape[0]).astype(np.int32))
    edge_lanes = min(EDGE_LANES, syn.shape[0])
    edges = np.resize(np.array([0, 1, 31, 32, 33, 63, 64, n], np.int32), edge_lanes)
    cases = (
        ("growth_round", syn, grown, in_bit.sum(dim=1).to(torch.int32)),
        ("random_count", syn, order, random.to(syn.device)),
        ("count_edges", syn[:edge_lanes].contiguous(), order[:edge_lanes].contiguous(),
         torch.from_numpy(edges).to(syn.device)),
    )
    for case, s, o, count in cases:
        r4 = gf2_cuda.masked_solve_reference(tg, s, o, count)
        r5 = gf2_cuda.masked_export_reference(tg, s, o, count)
        for variant in variants:
            k4 = run("masked_solve", variant, tg, s, o, count)
            k5 = run("masked_export", variant, tg, s, o, count)
            n4, n5 = int(_lanes_differ(k4, r4).sum()), int(_lanes_differ(k5, r5).sum())
            e4, e5 = _max_abs_err(k4, r4), _max_abs_err(k5, r5)
            err["masked_solve"] = max(err["masked_solve"], e4)
            err["masked_export"] = max(err["masked_export"], e5)
            phase("k4_k5_vs_plain", config=name, case=case,
                  variant=named("masked_solve", variant),
                  lanes=s.shape[0], k4_differing_lanes=n4, k5_differing_lanes=n5,
                  max_abs_err=max(e4, e5), mean_count=float(count.float().mean()),
                  narrow_lanes=int((count < 32).sum()))
            if n4 or n5 or e4 or e5:
                raise AssertionError(
                    f"K4'/K5' differ from their plain versions: {name}/{case}/{variant}")
    return err


def elim_work(kname, args, ref):
    """Per-lane ``(steps, pivots, words)`` of one K2'-K5' call on this run's
    data, from its plain output ``ref``: the columns the lane must walk
    (K2': up to the pivot that ends it; K3': up to its last pivot, the
    rank-th; K4' and K5': its count), the pivots it takes, and the words of
    a pivot row (K2' and K4' need only the columns walked and the syndrome,
    ceil((steps+1)/32) words; K3' and K5' export full rows of Wp)."""
    tgx, syn, order, last = args
    n, Wp = tgx.n, tgx.packed.shape[1]
    if kname == "osd0":
        all_cols = torch.full((syn.shape[0],), n, dtype=torch.int64, device=syn.device)
        steps = gf2_cuda.columns_walked(tgx, syn, order, all_cols, last, True)
        pivots = gf2_cuda.pivots_taken(tgx, syn, order, all_cols, last, True)
        return steps, pivots, (steps + 32) // 32
    if kname == "masked_solve":
        steps = last.long().clamp(0, n)
        pivots = gf2_cuda.pivots_taken(tgx, syn, order, last, tgx.m + 1, False)
        return steps, pivots, (steps + 32) // 32
    _, col_of_row, used = ref
    pivots = used.sum(dim=1)
    if kname == "masked_export":
        steps = last.long().clamp(0, n)
    else:
        # each row's pivot column's place in the lane's order; the lane stops
        # after its last pivot
        place = torch.empty_like(order, dtype=torch.long).scatter_(
            1, order.long(), torch.arange(n, device=order.device).expand(order.shape))
        at = torch.gather(place, 1, col_of_row.long().clamp(max=n - 1))
        steps = torch.where(used, at, -1).max(dim=1).values + 1
    return steps, pivots, torch.full_like(pivots, Wp)


def time_elim(kname, args, plain_reps=2, reps=5, variants=ELIM_VARIANTS):
    """One K2'-K5' call held against its plain version in every variant of
    ``variants`` (forced; raises unless every lane is bit-identical), timed
    in each (device time, :func:`device_ms`) and in its plain version,
    beside its bound: the bytes the function must move (the call's tensors
    and the graph array the warp variant reads, each read once, but of each
    lane's order row only the ``steps`` entries it walks; the outputs
    written once) over the HBM rate, or its operations (:func:`gf2_ops`,
    :func:`elim_work`). ``ms`` is the default variant's time, ``call_ms``
    its eager call's."""
    cuda_fn = getattr(gf2_cuda, f"{kname}_cuda")
    plain_fn = getattr(gf2_cuda, f"{kname}_reference")
    tgx, syn, order, last = args
    ref = plain_fn(*args)
    differing, err = 0, 0
    for v in variants:
        ker = cuda_fn(*args, variant=v)
        torch.cuda.synchronize()
        nlanes, e = int(_lanes_differ(ker, ref).sum()), _max_abs_err(ker, ref)
        if nlanes or e:
            raise AssertionError(f"{kname} ({v}) differs from its plain version on "
                                 f"{nlanes} of {syn.shape[0]} lanes of a timed call")
        differing, err = differing + nlanes, max(err, e)
    steps, pivots, words = elim_work(kname, args, ref)
    graph_array = tgx.var_chks if kname in ("osd0", "masked_solve") else tgx.packed
    moved = nbytes(syn, graph_array, *ref) + 4 * int(steps.sum())
    if torch.is_tensor(last):
        moved += nbytes(last)
    variant_ms = {v: device_ms(lambda v=v: cuda_fn(*args, variant=v)) for v in variants}
    default = gf2_cuda.elim_variant(kname, tgx.m, tgx.n)
    bound_ms, bound_by = bound(moved, gf2_ops(tgx, int(steps.sum()), int((pivots * words).sum())))
    return {"ms": variant_ms[default], "call_ms": cuda_ms(lambda: cuda_fn(*args), reps),
            "plain_ms": cuda_ms(lambda: plain_fn(*args), plain_reps),
            "bound_ms": bound_ms, "bound_by": bound_by, "variants_ms": variant_ms,
            "default": default, "steps": int(steps.sum()), "pivots": int(pivots.sum()),
            "differing_lanes": differing, "max_abs_err": err, "lane_steps": steps}


def elim_fields(t) -> dict:
    """The fields a line of :func:`time_elim`'s numbers prints."""
    keys = ("differing_lanes", "max_abs_err", "default", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "steps", "pivots")
    return {k: t[k] for k in keys} | {"share_of_bound": t["bound_ms"] / t["ms"]} | {
        f"{k}_ms": v for k, v in t["variants_ms"].items()}


def time_k2(name, args, variants=ELIM_VARIANTS, **extra):
    """K2' at one call's shape: every variant held against the plain version
    and timed (:func:`time_elim`), beside the columns its lanes walk before
    the fast exit, which decide what a lane of the warp variant does (above
    32 it starts again at full width). Returns the kernels line's numbers
    and the largest error."""
    t = time_elim("osd0", args, variants=variants)
    walked = t["lane_steps"].float()
    phase(name, **extra, lanes=args[1].shape[0], **elim_fields(t),
          columns_walked_mean=float(walked.mean()), columns_walked_max=int(walked.max()),
          share_above_32=float((walked > 32).float().mean()),
          share_above_64=float((walked > 64).float().mean()))
    return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, t["max_abs_err"]


def time_sizes(name, code, lanes=4096, variants=ELIM_VARIANTS):
    """K3' on reliability orders and K4'/K5' on a first growth round of
    ``lanes`` syndromes of ``code``, each timed in every variant of
    ``variants``."""
    graph = compile_pcm(code.hx)
    tgx = graph_to_torch(graph, "cuda")
    syn = torch.from_numpy(workload(graph.dense, lanes, seed=17)[1]).to("cuda")
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, ERROR_RATE))).to("cuda")
    llr = bp_cuda.bp_parallel_cuda(tgx, syn, llr0, MINIMUM_SUM, MAX_ITER, MS_FACTOR).llr_posterior
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()
    _, bad = gf2_cuda.masked_solve_reference(
        tgx, syn, order, torch.zeros(lanes, dtype=torch.int32, device="cuda"))
    in_bit, _ = uf.grow_round(tgx, torch.zeros_like(llr, dtype=torch.bool), bad,
                              uf.llr_rank(llr), 1)
    grown = uf.cluster_columns(in_bit, llr)
    rank = gf2.batched_rank(graph.dense)
    for kname, args in (("rref_export", (tgx, syn, order, rank)),
                        ("masked_solve", (tgx, syn, *grown)),
                        ("masked_export", (tgx, syn, *grown))):
        t = time_elim(kname, args, plain_reps=1, variants=variants)
        phase(f"{kname}_size_time", config=name, m=graph.m, n=graph.n, lanes=lanes,
              **elim_fields(t))


def count_shape(count) -> dict:
    """Lanes, mean and largest count, and lanes K4' keeps in registers."""
    return {"lanes": count.numel(), "mean_count": float(count.float().mean()),
            "max_count": int(count.max()), "narrow_lanes": int((count < 32).sum())}


def time_k4_calls(label, calls, plain_reps=1):
    """K4' over every call a path made, each held against its plain version
    and timed as :func:`time_elim` does, and printed; returns the sums (the
    kernels line's numbers) and the largest error."""
    total = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    err = 0
    variants = {}
    bound_by = {"bytes": 0.0, "operations": 0.0}  # the summed bound, by what bounds each call
    for i, args in enumerate(calls):
        t = time_elim("masked_solve", args, plain_reps=plain_reps)
        phase("masked_solve_call", path=label, call=i, **count_shape(args[3]), **elim_fields(t))
        for k in total:
            total[k] += t[k]
        bound_by[t["bound_by"]] += t["bound_ms"]
        err = max(err, t["max_abs_err"])
        for k, v in t["variants_ms"].items():
            variants[k] = variants.get(k, 0.0) + v
    phase("masked_solve_time", path=label, calls=len(calls), ms=total["ms"],
          call_ms=total["call_ms"], plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
          share_of_bound=total["bound_ms"] / total["ms"],
          **{f"{k}_ms": v for k, v in variants.items()})
    return {k: total[k] for k in ("ms", "plain_ms", "bound_ms")} | {
        "bound_by": max(bound_by, key=bound_by.get), "max_abs_err": err}


def k4_residency(graph, paths) -> None:
    """What K4's full-width shared-memory reservation costs: warps of its
    warp variant resident on an SM (the CUDA occupancy calculator) when a
    lane reserves rows of Wp words (as launched), of 2 words, or nothing
    (narrow lanes only, which touch no shared memory), beside how many of
    each path's lanes are wide (count >= 32) or above 2 words (count >=
    64)."""
    lib = _build.library()
    Wp = (graph.n + 32) // 32
    counts = {label: torch.cat([args[3] for args in calls]) for label, calls in paths.items()}
    phase("k4_resident_warps", m=graph.m,
          sms=torch.cuda.get_device_properties(0).multi_processor_count,
          full_width=lib.ldpc_masked_solve_resident_warps(graph.m, Wp),
          two_words=lib.ldpc_masked_solve_resident_warps(graph.m, 2),
          none=lib.ldpc_masked_solve_resident_warps(graph.m, 0),
          **{f"{label}_{k}": v for label, c in counts.items()
             for k, v in (("lanes", c.numel()), ("wide", int((c >= 32).sum())),
                          ("above_two_words", int((c >= 64).sum())))})


def captured_calls(module, name, run):
    """The arguments of every call ``run()`` makes to ``module.name``."""
    calls = []
    original = getattr(module, name)

    def record(*args):
        calls.append(args)
        return original(*args)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, original)
    return calls


def reset_counters() -> None:
    bp_cuda.LAUNCHES = 0
    bp_cuda.STATE_LAUNCHES.update(shared=0, device=0)
    bp_cuda.DTYPE_LAUNCHES.update(float32=0, float64=0)
    mbp_cuda.LAUNCHES = 0
    mbp_cuda.DTYPE_LAUNCHES.update(float32=0, float64=0)
    for by_variant in gf2_cuda.VARIANT_LAUNCHES.values():
        by_variant.update(dict.fromkeys(by_variant, 0))
    flip.FLIP_LAUNCHES = 0
    uf.HOST_SYNCS = 0
    uf.GROWTH_ROUNDS = 0
    bp_fold.LAUNCHES.update(dict.fromkeys(bp_fold.LAUNCHES, 0))
    for by_state in bp_fold.STATE_LAUNCHES.values():
        by_state.update(shared=0, device=0)


def read_counters() -> dict:
    return {
        "bp_parallel": bp_cuda.LAUNCHES,
        "bp_shared_state": bp_cuda.STATE_LAUNCHES["shared"],
        "bp_device_state": bp_cuda.STATE_LAUNCHES["device"],
        "bp_parallel_float64": bp_cuda.DTYPE_LAUNCHES["float64"],
        "mbp": mbp_cuda.LAUNCHES,
        "mbp_float32": mbp_cuda.DTYPE_LAUNCHES["float32"],
        "mbp_float64": mbp_cuda.DTYPE_LAUNCHES["float64"],
        **{kernel: sum(by_variant.values())
           for kernel, by_variant in gf2_cuda.VARIANT_LAUNCHES.items()},
        **{f"{kernel}_{variant}": count
           for kernel, by_variant in gf2_cuda.VARIANT_LAUNCHES.items()
           for variant, count in by_variant.items()},
        "flip": flip.FLIP_LAUNCHES,
        **bp_fold.LAUNCHES,
        **{f"{kernel}_{state}_state": count
           for kernel, by_state in bp_fold.STATE_LAUNCHES.items()
           for state, count in by_state.items()},
        "host_syncs": uf.HOST_SYNCS,
        "growth_rounds": uf.GROWTH_ROUNDS,
    }


ROW_CHECKS = ("all", "valid", "converged", "soft")


def drive_decoder(p: DecodePath, H, syn_np, cpu_rows=CPU_ROWS):
    """One path: ``p.make(device).decode_batch(x, *p.args)`` on the whole
    batch (``x`` the syndromes, or ``p.inputs`` of them), with the launch
    counters set to 0 just before the first call and read just after it.
    Checks H x = s on the rows the decoder guarantees it for (``solves``:
    every row, the rows ``valid_batch`` marks, the rows ``converge_batch``
    marks, or, ``"soft"``, every row against its hardened final soft
    syndrome, ``soft_syndrome_batch <= 0``, which soft-information BP may
    have flipped from s), that each kernel in ``kernels`` launched, and that
    the first ``cpu_rows`` rows equal the CPU path's, with
    ``converge_batch``, ``iter_batch``, ``valid_batch`` and
    ``soft_syndrome_batch`` where the decoder has them; then times
    ``rounds`` calls after a settle call. Returns the counters."""
    label, make, kernels, rounds, args, solves = (
        p.label, p.make, p.kernels, p.rounds, p.args, p.solves)
    if solves not in ROW_CHECKS:
        raise ValueError(f"solves must be one of {ROW_CHECKS}, not {solves!r}")
    x = syn_np if p.inputs is None else p.inputs(syn_np)
    reset_counters()
    dec = make("cuda")
    t0 = time.perf_counter()
    out = dec.decode_batch(x, *args)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = read_counters()
    flags = {a: getattr(dec, a).copy()
             for a in ("converge_batch", "iter_batch", "valid_batch", "soft_syndrome_batch")
             if getattr(dec, a, None) is not None}
    rows = {"all": np.ones(len(syn_np), bool), "valid": flags.get("valid_batch"),
            "converged": flags.get("converge_batch"), "soft": np.ones(len(syn_np), bool)}[solves]
    target = (flags["soft_syndrome_batch"] <= 0).astype(np.uint8) if solves == "soft" else syn_np
    solved = ((out.astype(np.int64) @ H.T) % 2 == target).all(axis=1)
    if not solved[rows].all():
        raise AssertionError(f"{label}: decode_batch output does not satisfy H x = s "
                             f"on the {solves} rows")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: the path skipped kernels {missing}: {counts}")
    cpu = make("cpu")
    out_cpu = cpu.decode_batch(x[:cpu_rows], *args)
    if not (out_cpu == out[:cpu_rows]).all() or any(
        not (getattr(cpu, a) == f[:cpu_rows]).all() for a, f in flags.items()
    ):
        raise AssertionError(f"{label}: decode_batch on the card differs from the CPU")
    dec.decode_batch(x, *args)  # settle
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        dec.decode_batch(x, *args)
        times.append(time.perf_counter() - t0)
    extra = {}
    if solves == "soft":
        extra["rows_solving_s"] = int(
            ((out.astype(np.int64) @ H.T) % 2 == syn_np).all(axis=1).sum())
    if "converge_batch" in flags:
        extra["not_converged"] = int((~flags["converge_batch"]).sum())
    if "valid_batch" in flags:
        extra["invalid"] = int((~flags["valid_batch"]).sum())
    phase(
        "decode_batch", config=label, syndromes=len(syn_np), warmup_s=round(warm_s, 3),
        median_s=statistics.median(times), syndromes_per_s=len(syn_np) / statistics.median(times),
        **extra, hx_eq_s_rows=f"{solves}:{int(rows.sum())}", cpu_rows_equal=cpu_rows,
        launches=json.dumps({k: v for k, v in counts.items() if v}, separators=(",", ":")),
    )
    return counts


def compare_flip(name, tg, syn, max_iter, pfreq, seed=7):
    """The flip kernel against its plain version: bit-identical decodings,
    flags and iterations on every lane."""
    ker = flip.flip_cuda(tg, syn, max_iter, pfreq, seed)
    ref = flip.flip_reference(tg, syn, max_iter, pfreq, seed)
    torch.cuda.synchronize()
    nlanes = int(_lanes_differ(ker, ref).sum())
    phase("flip_vs_plain", config=name, pfreq=pfreq, max_iter=max_iter, lanes=syn.shape[0],
          differing_lanes=nlanes, converged=int(ker[1].sum()))
    if nlanes:
        raise AssertionError(f"the flip kernel differs from its plain version: {name}/{pfreq}")
    return _max_abs_err(ker, ref)


def time_flip(name, tg, graph, syn, max_iter, pfreq, **extra):
    """One flip call held against its plain version (:func:`compare_flip`),
    then timed beside it and its bound: the call's tensors each moved once,
    and the sweeps a lane surely completes (all but its last on a converged
    lane, which may stop mid-sweep; one on a lane that stops at its fixpoint,
    every one with p-flip on), each testing the dv checks of every bit and
    comparing. Returns the kernels line's numbers and the largest error."""
    err = compare_flip(extra.get("config", "surface13/main"), tg, syn, max_iter, pfreq, seed=1)
    out = flip.flip_cuda(tg, syn, max_iter, pfreq, 1)
    _, conv, iters = out
    unconverged = max_iter if pfreq else 1
    sweeps = int(torch.where(conv, iters - 1, unconverged).clamp(min=0).sum())
    numbers = timed(
        name, f"B={syn.shape[0]},max_iter={max_iter},pfreq={pfreq}",
        lambda: flip.flip_cuda(tg, syn, max_iter, pfreq, 1),
        lambda: flip.flip_reference(tg, syn, max_iter, pfreq, 1),
        nbytes(syn, tg.var_chks, *out), float(sweeps) * (graph.nnz + graph.n),
        plain_reps=1, full_sweeps=sweeps, **extra,
    )
    return numbers, err


FOLD_KERNELS = ("bp_serial", "bp_soft_info", "bp_parallel_exact")
ORDER_NAMES = {bp_fold.ORDER_FIXED: "serial", bp_fold.ORDER_TABLE: "random",
               bp_fold.ORDER_RELATIVE: "serial_relative"}


def posterior_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries that differ (equal infinities and NaN
    pairs count 0)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, (a - b).abs()).max()) if a.numel() else 0.0


def split(out):
    """(BpResult, K7''s soft syndrome or None) of a fold engine's output."""
    return (out, None) if isinstance(out, BpResult) else out


def hold_fold(kernel, ker, ref, method, config):
    """A fold engine's outputs against its plain version's: min-sum
    bit-identical (decisions, posteriors, flags, iterations; K7' its soft
    syndrome too), product-sum equal decisions, flags and iterations with
    posteriors within rtol 1e-4 (float32) or 1e-9 (float64), atol 1e-5 (the
    CUDA math library's tanh and log on both sides; a cumulative product may
    round differently). Returns (differing lanes, largest error)."""
    (kr, ks), (rr, rs) = split(ker), split(ref)
    lanes = ((kr.decoding != rr.decoding).any(dim=1) | (kr.converged != rr.converged)
             | (kr.iterations != rr.iterations))
    nlanes = int(lanes.sum())
    err = posterior_err(kr.llr_posterior, rr.llr_posterior)
    if ks is not None:
        err = max(err, posterior_err(ks, rs))
    if method == MINIMUM_SUM:
        if nlanes or err != 0.0:
            raise AssertionError(f"{kernel} min-sum differs from its plain version: {config}")
    else:
        rtol = 1e-4 if kr.llr_posterior.dtype == torch.float32 else 1e-9
        close = torch.isclose(kr.llr_posterior, rr.llr_posterior, rtol=rtol, atol=1e-5,
                              equal_nan=True)
        if nlanes or not bool(close.all()):
            raise AssertionError(f"{kernel} product-sum beyond its tolerance: {config}")
    return nlanes, err


def fold_args(kernel, tg, syn, llr0, method, alpha, max_iter, mode=bp_fold.ORDER_FIXED):
    """The plain version's and the wrapper's arguments for one call; the
    random serial table is drawn on the card from a generator seeded 7."""
    if kernel == "bp_serial":
        order = None
        if mode == bp_fold.ORDER_FIXED:
            order = torch.arange(tg.n, dtype=torch.int32, device=syn.device)
        elif mode == bp_fold.ORDER_TABLE:
            gen = torch.Generator(device=syn.device)
            gen.manual_seed(7)
            order = serial_order_table(tg.n, max_iter, gen, syn.device)
        return (tg, syn, llr0, method, max_iter, alpha, order, mode)
    if kernel == "bp_soft_info":
        return (tg, syn, llr0, max_iter, alpha, SOFT_CUTOFF)
    return (tg, syn, llr0, method, max_iter, alpha)


def fold_fns(kernel):
    return getattr(bp_fold, f"{kernel}_reference"), getattr(bp_fold, f"{kernel}_cuda")


def fold_levels(kernel, args) -> dict:
    """The wrapper's ``levels`` keyword for a K6' call in a given order or
    table, or a K7' call (index order), made once on the host so that timed
    calls (a CUDA-graph capture, which cannot copy to the host) reuse it;
    {} for serial-relative (levels built in the kernel) and K8'."""
    tg = args[0]
    if kernel == "bp_soft_info":
        order = torch.arange(tg.n, dtype=torch.int32, device=args[1].device)
    elif kernel == "bp_serial" and args[-1] != bp_fold.ORDER_RELATIVE:
        order = args[6]
    else:
        return {}
    return {"levels": bp_fold.level_schedule(tg, order)}


EXACT_PHASES = ("prologue", "check", "bit", "syndrome", "epilogue")


def fold_profile(kernel, args, kw) -> dict:
    """One K6'-K8' call with its per-lane counters. K6'/K7': levels per
    sweep (mean over sweeps, the most in one) and, for serial-relative,
    each phase's share of the lanes' clock cycles (sort, levels pass with
    bucketing, sweeps). K8': each phase's share of the lanes' cycles
    (:data:`EXACT_PHASES`) and the mean cycles of a lane-iteration."""
    prof = torch.zeros((args[1].shape[0], 5), dtype=torch.int64, device=args[1].device)
    res = split(getattr(bp_fold, f"{kernel}_cuda")(*args, **kw, profile=prof))[0]
    torch.cuda.synchronize()
    tot = prof.sum(dim=0).double()
    if kernel == "bp_parallel_exact":
        cycles = float(tot.sum())
        return {f"cycle_share_{k}": float(tot[i]) / cycles for i, k in enumerate(EXACT_PHASES)} | {
            "cycles_per_lane_iteration": cycles / max(int(res.iterations.sum()), 1)}
    out = {"levels_per_sweep_mean": float(tot[3]) / max(int(res.iterations.sum()), 1),
           "levels_per_sweep_max": int(prof[:, 4].max())}
    if kernel == "bp_serial" and args[-1] == bp_fold.ORDER_RELATIVE:
        cycles = float(tot[:3].sum())
        out |= {f"cycle_share_{k}": float(tot[i]) / cycles
                for i, k in enumerate(("sort", "levels_pass", "sweep"))}
    return out


def compare_fold(kernel, config, args, states=("shared", "device")):
    """K6'-K8' (``kernel``) against the plain version on ``args``, once for
    each of ``states`` (forced; None: the footprint's choice); each launch
    must move its state's counter. Returns the first result and the largest
    error."""
    plain, cuda = fold_fns(kernel)
    method = MINIMUM_SUM if kernel == "bp_soft_info" else args[3]
    ref = plain(*args)
    first, worst = None, 0.0
    tg, lanes_in, llr0 = args[0], args[1], args[2]
    relative = kernel == "bp_serial" and args[-1] == bp_fold.ORDER_RELATIVE
    for state in states:
        counted = state or bp_fold.state_variant(kernel, tg.m, tg.n, tg.dc, tg.dv, llr0.dtype,
                                                 relative)
        before = bp_fold.STATE_LAUNCHES[kernel][counted]
        ker = cuda(*args, state=state)
        torch.cuda.synchronize()
        if bp_fold.STATE_LAUNCHES[kernel][counted] != before + 1:
            raise AssertionError(f"{kernel}: the {counted} state's counter did not move")
        nlanes, err = hold_fold(kernel, ker, ref, method, config)
        res = split(ker)[0]
        phase(f"{kernel}_vs_plain", config=config, dtype=str(llr0.dtype)[6:], state=counted,
              lanes=lanes_in.shape[0], differing_lanes=nlanes, max_abs_err=err,
              converged=int(res.converged.sum()), lane_iterations=int(res.iterations.sum()))
        first = ker if first is None else first
        worst = max(worst, err)
    return first, worst


def fold_ops(kernel, graph, lane_iterations: int, relative: bool = False) -> float:
    """Operations of K6'-K8' over ``lane_iterations`` (a floor, each counted
    once). K6'/K7' per edge: its check's other slots (|v|, a min compare, a
    sign test each), the scale and the sign (2); per bit of degree d: each
    slot's message folds d values (d*d adds), the posterior d adds and the
    decision; per edge the syndrome test. K7' adds 8 per edge for the
    virtual-update rules; serial-relative adds n*ceil(log2 n) compares for
    the ranking, what a comparison sort needs (K6''s counting rank does
    n*n: that is the kernel's choice, not the function's work). K8' has its
    own count (:func:`exact_ops`)."""
    rows = graph.chk_mask.sum(axis=1).astype(np.int64)
    cols = graph.var_mask.sum(axis=1).astype(np.int64)
    per = (3 * int((rows * (rows - 1)).sum()) + 2 * graph.nnz
           + int((cols * cols).sum()) + int((cols + 1).sum()) + graph.nnz)
    if kernel == "bp_soft_info":
        per += 8 * graph.nnz
    if relative:
        per += graph.n * math.ceil(math.log2(graph.n))
    return float(lane_iterations) * per


def exact_ops(graph, lane_iterations: int):
    """K8''s min-sum operations over ``lane_iterations`` as ``(float64,
    integer)``, each counted once. float64, per edge: the min1 and min2
    compares and the sign test (v <= 0); per row: alpha times min1 and
    min2; per bit of degree d: the posterior's d adds, d adds of partial
    plus suffix and d - 1 suffix adds, and the decision compare. Integer
    and bit operations, per edge: |v| and the output's sign (the top bit
    cleared or flipped), the sign parity, and the syndrome test's parity.
    The bit-to-check messages are stored, so nothing is subtracted."""
    cols = graph.var_mask.sum(axis=1).astype(np.int64)
    f64 = 3 * graph.nnz + 2 * graph.m + int((3 * cols - 1).clip(min=0).sum()) + graph.n
    ints = 4 * graph.nnz
    return float(lane_iterations) * f64, float(lane_iterations) * ints


def time_fold(name, kernel, graph, args, **extra):
    """One K6'-K8' call at a main-path shape: the plain version once (its
    time from CUDA events), the kernel held against it, then the kernel's
    device time (:func:`device_ms`) and eager ``call_ms`` beside the bound:
    the call's tensors moved once (inputs, graph arrays, schedule; outputs)
    over the HBM rate, or the operations over their rate (``ops_rate``):
    :func:`fold_ops` over this run's lane-iterations at the float32 rate,
    or for K8' :func:`exact_ops`' float64 operations at
    :data:`F64_OPS_PER_S` or its integer operations at
    :data:`INT_OPS_PER_S`, whichever takes longer. Each line adds the lanes' counters
    (:func:`fold_profile`); K8''s adds its lanes a block, the lanes
    resident on an SM and a lane's shared bytes. Returns the kernels
    line's numbers and the largest error."""
    plain, cuda = fold_fns(kernel)
    method = MINIMUM_SUM if kernel == "bp_soft_info" else args[3]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ref = plain(*args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    kw = fold_levels(kernel, args)
    ker = cuda(*args, **kw)
    torch.cuda.synchronize()
    nlanes, err = hold_fold(kernel, ker, ref, method, name)
    res, soft_out = split(ker)
    lane_iterations = int(res.iterations.sum())
    tg = args[0]
    graph_arrays = (tg.chk_bits_t, tg.var_edges_t) if kernel == "bp_parallel_exact" else (
        tg.chk_bits, tg.var_edges)
    order = args[6] if kernel == "bp_serial" and args[6] is not None else None
    moved = nbytes(args[1], args[2], *graph_arrays, *res)
    if order is not None:
        moved += nbytes(order)
    if soft_out is not None:
        moved += nbytes(soft_out)
    relative = kernel == "bp_serial" and args[-1] == bp_fold.ORDER_RELATIVE
    if kernel == "bp_parallel_exact":
        assert method == MINIMUM_SUM, "exact_ops counts min-sum"
        f64, ints = exact_ops(graph, lane_iterations)
        ops, rate, rate_name = max((f64, F64_OPS_PER_S, "float64"), (ints, INT_OPS_PER_S, "int32"),
                                   key=lambda x: x[0] / x[1])
    else:
        assert args[2].dtype == torch.float32, "fold_ops counts at the float32 rate"
        ops = fold_ops(kernel, graph, lane_iterations, relative)
        rate, rate_name = OPS_PER_S, "float32"
    bound_ms, bound_by = bound(moved, ops, rate)
    ms = device_ms(lambda: cuda(*args, **kw))
    call_ms = cuda_ms(lambda: cuda(*args, **kw), 3)
    extra = fold_profile(kernel, args, kw) | extra
    if kernel == "bp_parallel_exact":
        state = bp_fold.state_variant(kernel, tg.m, tg.n, tg.dc, tg.dv, torch.float64)
        extra = {"resident_lanes_per_sm": bp_fold.exact_resident_lanes(tg, args[3], state),
                 "lane_bytes": _build.library().ldpc_bp_exact_lane_bytes(tg.m, tg.n, tg.dc)} | extra
    max_iter = args[3] if kernel == "bp_soft_info" else args[4]
    phase(name, shape=f"B={args[1].shape[0]},max_iter={max_iter}", dtype=str(args[2].dtype)[6:],
          ms=ms, call_ms=call_ms, plain_ms=plain_ms,
          bound_ms=bound_ms, bound_by=bound_by,
          ops_rate=f"{rate_name}:{rate}",
          share_of_bound=bound_ms / ms,
          lane_iterations=lane_iterations, differing_lanes=nlanes, max_abs_err=err,
          state=bp_fold.state_variant(kernel, tg.m, tg.n, tg.dc, tg.dv, args[2].dtype, relative),
          **extra)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}, err


def hold_mbp(ker, ref, config):
    """K9''s outputs against its plain version's: decisions, flags and
    iteration counts equal on every lane, posteriors within rtol 1e-9
    (float64) or 1e-4 (float32), atol 1e-5 (both sides call CUDA's exp, log
    and tanh). Returns (differing lanes, largest posterior error)."""
    nlanes = int(((ker[0] != ref[0]).any(dim=1) | (ker[2] != ref[2]) | (ker[3] != ref[3])).sum())
    err = posterior_err(ker[1], ref[1])
    rtol = 1e-9 if ker[1].dtype == torch.float64 else 1e-4
    close = torch.isclose(ker[1], ref[1], rtol=rtol, atol=1e-5, equal_nan=True)
    if nlanes or not bool(close.all()):
        raise AssertionError(f"K9' differs from its plain version: {config}")
    return nlanes, err


def compare_mbp(config, g, syn, chan, inv_alpha, method):
    """K9' against its plain version on the same inputs. Returns the
    largest posterior error."""
    ref = mbp.mbp_reference(g, syn, chan, inv_alpha, MAX_ITER, 0.0, method, MS_FACTOR)
    ker = mbp_cuda.mbp_cuda(g, syn, chan, inv_alpha, MAX_ITER, 0.0, method, MS_FACTOR)
    torch.cuda.synchronize()
    nlanes, err = hold_mbp(ker, ref, config)
    phase("mbp_vs_plain", config=config, dtype=str(chan.dtype)[6:], lanes=syn.shape[0],
          differing_lanes=nlanes, max_abs_err=err, converged=int(ker[2].sum()))
    return err


def mbp_ops(g, lane_iterations: int, method: int) -> float:
    """K9''s operations over ``lane_iterations`` (sweeps), each counted once
    and each exp, log and tanh as one operation (the card computes them
    from about twenty each, so this is a floor). Per edge of a row of
    degree r, its message from the r - 1 other cached values: min-sum |lam|,
    a min compare and a sign test each, then gamma times the least and the
    sign (2); product-sum a product each, two clips, 1 + p, 1 - p, the
    quotient, the log and the sign (6). Per qubit of degree d: 3 d products
    by the coefficient and 3 d adds, the 3 channel adds and the decision (5
    compares). Per edge: its new message (3 subtracts), the value (3 exp,
    the agreeing one plus 1, the other two summed, the quotient, + 1e-12,
    the log: 8; product-sum a product and a tanh more: 10) and the syndrome
    test (2 compares and a parity: 3)."""
    rows = (g.chk_bits < g.n).sum(dim=1).long().cpu()
    cols = (g.var_chks < g.m).sum(dim=1).long().cpu()
    edges = int(rows.sum())
    other = int((rows * (rows - 1)).sum())
    if method == MINIMUM_SUM:
        per = 3 * other + 2 * edges + 8 * edges
    else:
        per = other + 6 * edges + 10 * edges
    per += int((6 * cols).sum()) + 3 * g.n + 5 * g.n + 3 * edges + 3 * edges
    return float(lane_iterations) * per


GOLDEN_CONFIGS = [(0, 1, 1.0), (0, 0, 1.0), (0, 2, 1.0), (1, 1, 1.0), (1, 1, 0.625),
                  (1, 1, 0.0), (1, 0, 1.0), (1, 0, 0.625), (1, 2, 0.625)]


def golden_on_card() -> int:
    """The reference C++ decoder's golden BP decodings replayed through
    ``BpDecoder(device="cuda", dtype=float64)`` (max_iter 20) at
    tests/test_bp_golden.py's tiers, min-sum held bit for bit with its
    posteriors. Returns the configurations replayed."""
    data = np.load(GOLDEN)
    names = {0: "product_sum", 1: "minimum_sum"}
    scheds = {0: "serial", 1: "parallel", 2: "serial_relative"}
    count = 0
    for cname in ("hamming3", "rep7", "ring8"):
        H, syn = data[f"{cname}/pcm"], data[f"{cname}/syndromes"]
        for method, sched, alpha in GOLDEN_CONFIGS:
            key = f"{cname}/{method}_{sched}_{alpha}"
            want_conv = data[f"{key}/conv"].astype(bool)
            want_dec, want_iters = data[f"{key}/dec"], data[f"{key}/iters"]
            d = ldpc_tpu_torch.BpDecoder(
                H, error_channel=data[f"{cname}/channel"], max_iter=20,
                bp_method=names[method], schedule=scheds[sched], ms_scaling_factor=alpha,
                input_vector_type="syndrome", dtype="float64", device="cuda")
            dec = d.decode_batch(syn)
            conv, iters = d.converge_batch.astype(bool), d.iter_batch
            llr = torch.from_numpy(d.log_prob_ratios_batch)
            err = posterior_err(llr, torch.from_numpy(data[f"{key}/llr"]))
            if method == 1 or sched == 1:
                ok = (conv == want_conv).all() and (dec == want_dec).all() and (
                    iters == want_iters).all() and err <= (0.0 if method == 1 else 1e-4)
            elif sched == 0:
                ok = (conv == want_conv).all() and (dec[want_conv] == want_dec[want_conv]).all() \
                    and (iters[want_conv] == want_iters[want_conv]).all()
            else:
                ok = abs(int(conv.sum()) - int(want_conv.sum())) <= 8 and (
                    dec[conv] @ H.T % 2 == syn[conv]).all()
            if not ok:
                raise AssertionError(f"golden BP replay on the card failed: {key}")
            count += 1
    return count


def stats_record(make, syn_np, row, device) -> dict:
    """BpLsdDecoder statistics of ``row`` on ``device``, without the
    elapsed time."""
    dec = make(device)
    dec.set_do_stats(True, row=row)
    dec.decode_batch(syn_np)
    record = dataclasses.asdict(dec.statistics)
    record.pop("elapsed_time")
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    phase(
        "env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
    )

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=round(time.perf_counter() - t0, 3))
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    code, H, syn_np = main_workload()
    graph = compile_pcm(code.hx)
    tg = graph_to_torch(graph, dev)
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, ERROR_RATE))).to(dev)
    syn_all = torch.from_numpy(syn_np).to(dev)
    syn_k = syn_all[:KERNEL_BATCH].contiguous()

    tor = toric_code(20)
    H20 = np.asarray(tor.hx.todense(), np.uint8)
    graph20 = compile_pcm(tor.hx)
    tg20 = graph_to_torch(graph20, dev)
    llr20 = torch.from_numpy(channel_llr(np.full(graph20.n, ERROR_RATE))).to(dev)
    syn20 = torch.from_numpy(workload(H20, KERNEL_BATCH)[1]).to(dev)

    # ---- 3. K1' against its plain version ------------------------------------
    # each in the place the footprint chooses for a lane's state, then in
    # device memory, forced
    k1_err = 0.0
    posteriors = {}
    for cname, tgx, syn, l0 in (("surface13", tg, syn_k, llr0), ("toric20", tg20, syn20, llr20)):
        for mname, method, alpha in (
            ("ms0.625", MINIMUM_SUM, MS_FACTOR),
            ("ms_dynamic", MINIMUM_SUM, 0.0),
            ("product_sum", PRODUCT_SUM, 1.0),
        ):
            res, err = compare_bp(f"{cname}/{mname}", tgx, syn, l0, method, alpha)
            k1_err = max(k1_err, err)
            if mname == "ms0.625":
                posteriors[cname] = res.llr_posterior.contiguous()
    # a code whose lane state exceeds the shared-memory budget takes the
    # device-memory variant by itself
    tor31 = toric_code(31, compute_logicals=False)
    graph31 = compile_pcm(tor31.hx)
    if bp_cuda.state_variant(graph31.m, graph31.n, graph31.dc) != "device":
        raise AssertionError("toric d=31 should keep its K1' state in device memory")
    syn31 = torch.from_numpy(workload(np.asarray(tor31.hx.todense(), np.uint8), 400)[1]).to(dev)
    llr31 = torch.from_numpy(channel_llr(np.full(graph31.n, ERROR_RATE))).to(dev)
    tg31 = graph_to_torch(graph31, dev)
    res31, err = compare_bp("toric31/ms0.625", tg31, syn31, llr31, MINIMUM_SUM, MS_FACTOR,
                            states=(None,))
    k1_err = max(k1_err, err)

    # times at the main path's two K1' calls: phase-1 BP on the whole batch,
    # then full depth on the lanes phase 1 leaves unconverged (the bucket);
    # beside them the device-memory state variant at the same shape. Both
    # variants are first held against the plain version at that shape,
    # where the last block of lanes is part-filled.
    def k1_timed(name, syn, iters):
        out, err = compare_bp("surface13/ms0.625", tg, syn, llr0, MINIMUM_SUM, MS_FACTOR, iters)
        lane_iterations = int(out.iterations.sum())
        device_state_ms = cuda_ms(lambda: bp_cuda.bp_parallel_cuda(
            tg, syn, llr0, MINIMUM_SUM, iters, MS_FACTOR, state="device"), 5)
        numbers = timed(
            name, f"B={syn.shape[0]},max_iter={iters}",
            lambda: bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, iters, MS_FACTOR),
            lambda: bp_cuda.bp_parallel_reference(tg, syn, llr0, MINIMUM_SUM, iters, MS_FACTOR),
            nbytes(syn, llr0, tg.chk_bits_t, tg.var_edges_t, *out), k1_ops(graph, lane_iterations),
            plain_reps=3, lane_iterations=lane_iterations,
            state=bp_cuda.state_variant(tg.m, tg.n, tg.dc), device_state_ms=device_state_ms,
        )
        return out, numbers, err

    phase1, k1_numbers, err = k1_timed("k1_time", syn_all, PHASE1_ITERS)
    bucket = syn_all[~phase1.converged].contiguous()
    k1_err = max(k1_err, err, k1_timed("k1_bucket_time", bucket, MAX_ITER)[2])

    # ---- 4. K2' against its plain version ------------------------------------
    rank13 = gf2.batched_rank(graph.dense)
    rank20 = gf2.batched_rank(graph20.dense)
    k2_err = compare_osd("surface13", tg, H, syn_k, posteriors["surface13"], rank13)
    k2_err = max(
        k2_err, compare_osd("toric20", tg20, H20, syn20, posteriors["toric20"], rank20)
    )
    # times at the main path's K2' call: the lanes full-depth BP fails
    full = bp_cuda.bp_parallel_cuda(tg, syn_all, llr0, MINIMUM_SUM, MAX_ITER, MS_FACTOR)
    failed = torch.nonzero(~full.converged).squeeze(1)
    syn_f = syn_all[failed].contiguous()
    order_f = torch.argsort(full.llr_posterior[failed], dim=1, stable=True)
    order_f = order_f.to(torch.int32).contiguous()
    k2_numbers, err = time_k2("k2_time", (tg, syn_f, order_f, rank13))
    order20 = torch.argsort(posteriors["toric20"], dim=1, stable=True).to(torch.int32).contiguous()
    k2_err = max(k2_err, err, time_k2("k2_size_time", (tg20, syn20, order20, rank20),
                                      config="toric20")[1])

    # ---- 4b. K3', K4', K5' against their plain versions ------------------------
    elim_err = {"rref_export": 0, "masked_solve": 0, "masked_export": 0}
    for cname, tgx, gx, syn in (("surface13", tg, graph, syn_k), ("toric20", tg20, graph20, syn20)):
        for k, v in compare_elim(cname, tgx, gx, syn, posteriors[cname]).items():
            elim_err[k] = max(elim_err[k], v)

    # times at the main paths' calls, captured from the slice-B decoders on
    # the failed lanes: K3' on the OSD-CS bucket, K4' on every growth round
    # of LSD-0 (summed), K5' on LSD-CS's final export
    llr_f = full.llr_posterior[failed].contiguous()
    channel = np.full(graph.n, ERROR_RATE)
    osd_cs = osd.make_osd_decoder(graph, channel, osd.COMBINATION_SWEEP, 5, dev)
    k3_args = captured_calls(gf2_cuda, "rref_export", lambda: osd_cs(syn_f, llr_f))[0]
    lsd0 = lsd.make_lsd_decoder(graph, lsd.LSD_0, 0, 1, dev)
    k4_calls = captured_calls(gf2_cuda, "masked_solve", lambda: lsd0(syn_f, llr_f))
    lsd_cs = lsd.make_lsd_decoder(graph, lsd.LSD_CS, 5, 1, dev)
    k5_args = captured_calls(gf2_cuda, "masked_export", lambda: lsd_cs(syn_f, llr_f))[-1]
    elim_numbers = {}
    for kname, args in (("rref_export", k3_args), ("masked_export", k5_args)):
        t = time_elim(kname, args)
        extra = count_shape(args[3]) if kname == "masked_export" else {"lanes": args[1].shape[0]}
        phase(f"{kname}_time", **extra, **elim_fields(t))
        elim_numbers[kname] = {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        elim_err[kname] = max(elim_err[kname], t["max_abs_err"])
    elim_numbers["masked_solve"] = time_k4_calls("lsd0", k4_calls)
    elim_err["masked_solve"] = max(elim_err["masked_solve"],
                                   elim_numbers["masked_solve"].pop("max_abs_err"))
    # K3', K4' and K5' on larger codes, in every variant: where the warp
    # variant stops paying (the per-lane budgets in csrc/gf2_elim.cu)
    for cname, size_code in (("surface17", surface_code(17)), ("toric20", tor)):
        time_sizes(cname, size_code)

    # ---- 4c. a code above a block's shared memory: toric d=31 ------------------
    # K2'-K5' by default, which must be the device variant, against their
    # plain versions; then the decoders that reach them, against the CPU path
    for kname in gf2_cuda.VARIANT_LAUNCHES:
        if gf2_cuda.elim_variant(kname, graph31.m, graph31.n) != "device":
            raise AssertionError(f"toric d=31 should take {kname}'s device variant")
    H31 = np.asarray(tor31.hx.todense(), np.uint8)
    post31 = res31.llr_posterior.contiguous()
    rank31 = gf2.batched_rank(graph31.dense)
    k2_err = max(k2_err, compare_osd("toric31", tg31, H31, syn31, post31, rank31, (None,)))
    for k, v in compare_elim("toric31", tg31, graph31, syn31, post31, (None,)).items():
        elim_err[k] = max(elim_err[k], v)
    order31 = torch.argsort(post31, dim=1, stable=True).to(torch.int32).contiguous()
    k2_err = max(k2_err, time_k2("k2_size_time", (tg31, syn31, order31, rank31),
                                 variants=("device",), config="toric31")[1])
    time_sizes("toric31", tor31, lanes=LARGE_ROWS, variants=("device",))
    rng31 = np.random.default_rng(31)
    errors31 = (rng31.random((LARGE_ROWS, graph31.n)) < LARGE_ERROR_RATE).astype(np.uint8)
    syn31_np = (errors31 @ H31.T % 2).astype(np.uint8)
    for p in large_paths(tor31.hx):
        counts = drive_decoder(p, H31, syn31_np, cpu_rows=LARGE_CPU_ROWS)
        reached = {k: v for k, v in counts.items() if k.endswith("_device") and v}
        phase("large_code", config=p.label, m=graph31.m, n=graph31.n, syndromes=LARGE_ROWS,
              error_rate=LARGE_ERROR_RATE, device_variant_launches=json.dumps(reached))

    # ---- 5. the flip sweep against its plain version -------------------------
    flip_err = 0
    for cname, tgx, gx, syn in (("surface13", tg, graph, syn_k), ("toric20", tg20, graph20, syn20)):
        for pfreq, sweeps in ((0, gx.n), (3, PFLIP_SWEEPS)):
            flip_err = max(flip_err, compare_flip(cname, tgx, syn, sweeps, pfreq))
    # times at FlipDecoder's main-path call (the whole batch, max_iter = n),
    # then with p-flip on and on toric d=20
    flip_numbers, err = time_flip("flip_time", tg, graph, syn_all, graph.n, 0)
    flip_err = max(flip_err, err)
    for name, tgx, gx, syn, sweeps, pfreq in (
        ("surface13/pflip", tg, graph, syn_all, PFLIP_SWEEPS, 3),
        ("toric20", tg20, graph20, syn20, graph20.n, 0),
    ):
        flip_err = max(flip_err, time_flip("flip_size_time", tgx, gx, syn, sweeps, pfreq,
                                           config=name)[1])

    # ---- 5b. the fold engines K6'-K8', K1' with its factor fixed, golden -----
    # each held against its plain version in both state variants (forced),
    # on surface d=13, toric d=20 and toric d=60 (float64: above the shared
    # budget, the device variant by default); then timed at the main paths'
    # calls, each first held against the plain version at that shape
    fold_err = dict.fromkeys(FOLD_KERNELS, 0.0)
    llr0_64, llr20_64 = (
        torch.from_numpy(channel_llr(np.full(g.n, ERROR_RATE), np.float64)).to(dev)
        for g in (graph, graph20))
    fix, tab, rel = bp_fold.ORDER_FIXED, bp_fold.ORDER_TABLE, bp_fold.ORDER_RELATIVE

    def fold_compare(kernel, config, tgx, syn, l0, method, alpha, mode=fix,
                     states=("shared", "device"), max_iter=MAX_ITER):
        args = fold_args(kernel, tgx, syn, l0, method, alpha, max_iter, mode)
        fold_err[kernel] = max(fold_err[kernel], compare_fold(kernel, config, args, states)[1])

    for mode, method, alpha, l0, mname in (
        (fix, MINIMUM_SUM, MS_FACTOR, llr0, "ms0.625"),
        (fix, MINIMUM_SUM, MS_FACTOR, llr0_64, "ms0.625"),
        (fix, PRODUCT_SUM, 1.0, llr0, "product_sum"),
        (rel, MINIMUM_SUM, MS_FACTOR, llr0, "ms0.625"),
        (rel, MINIMUM_SUM, 0.0, llr0_64, "ms_dynamic"),
        (tab, MINIMUM_SUM, 0.0, llr0, "ms_dynamic"),
        (tab, PRODUCT_SUM, 1.0, llr0_64, "product_sum"),
    ):
        fold_compare("bp_serial", f"surface13/{ORDER_NAMES[mode]}/{mname}", tg, syn_k, l0, method,
                     alpha, mode)
    fold_compare("bp_serial", "toric20/serial_relative/ms0.625", tg20, syn20, llr20_64,
                 MINIMUM_SUM, MS_FACTOR, rel)
    fold_compare("bp_serial", "toric20/serial/ms_dynamic", tg20, syn20, llr20, MINIMUM_SUM, 0.0)
    # a random order: levels several times wider than index order's, more than a chunk a step
    fold_compare("bp_serial", "toric20/random/ms0.625", tg20, syn20[:1024].contiguous(), llr20,
                 MINIMUM_SUM, MS_FACTOR, tab)
    tor60 = toric_code(FOLD_LARGE_DISTANCE, compute_logicals=False)
    graph60 = compile_pcm(tor60.hx)
    tg60 = graph_to_torch(graph60, dev)
    syn60 = torch.from_numpy(workload(graph60.dense, FOLD_LARGE_ROWS)[1]).to(dev)
    llr60_64 = torch.from_numpy(channel_llr(np.full(graph60.n, ERROR_RATE), np.float64)).to(dev)
    for kernel in FOLD_KERNELS:
        if bp_fold.state_variant(kernel, graph60.m, graph60.n, graph60.dc, graph60.dv,
                                 torch.float64) != "device":
            raise AssertionError(
                f"toric d={FOLD_LARGE_DISTANCE} should take {kernel}'s device state")
    fold_compare("bp_serial", f"toric{FOLD_LARGE_DISTANCE}/serial/ms0.625", tg60, syn60, llr60_64,
                 MINIMUM_SUM, MS_FACTOR, states=(None,), max_iter=FOLD_LARGE_ITERS)

    def scaled_soft(syn_np_rows, dtype):
        soft = torch.from_numpy(soft_syndromes(syn_np_rows)).to(dev)
        scale = torch.tensor(2.0 / (SOFT_SIGMA * SOFT_SIGMA), dtype=dtype, device=dev)
        return (soft.to(dtype) * scale).contiguous()

    for dtype, l0 in ((torch.float32, llr0), (torch.float64, llr0_64)):
        fold_compare("bp_soft_info", "surface13/soft", tg,
                     scaled_soft(syn_np[:KERNEL_BATCH], dtype), l0, MINIMUM_SUM, MS_FACTOR)
    fold_compare("bp_soft_info", "toric20/soft", tg20,
                 scaled_soft(syn20.cpu().numpy(), torch.float32), llr20, MINIMUM_SUM, MS_FACTOR,
                 states=(None,))
    for method, alpha, mname in ((MINIMUM_SUM, MS_FACTOR, "ms0.625"),
                                 (MINIMUM_SUM, 0.0, "ms_dynamic"),
                                 (PRODUCT_SUM, 1.0, "product_sum")):
        fold_compare("bp_parallel_exact", f"surface13/{mname}", tg, syn_k, llr0_64, method, alpha)
    fold_compare("bp_parallel_exact", "toric20/ms0.625", tg20, syn20, llr20_64, MINIMUM_SUM,
                 MS_FACTOR)
    fold_compare("bp_parallel_exact", f"toric{FOLD_LARGE_DISTANCE}/ms0.625", tg60, syn60, llr60_64,
                 MINIMUM_SUM, MS_FACTOR, states=(None,))
    # K1' with its factor fixed: single-scan
    for alpha in (MS_FACTOR, 0.0):
        ref = bp_cuda.bp_parallel_reference(tg, syn_k, llr0, MINIMUM_SUM, MAX_ITER, alpha,
                                            dynamic_alpha=False)
        ker = bp_cuda.bp_parallel_cuda(tg, syn_k, llr0, MINIMUM_SUM, MAX_ITER, alpha,
                                       dynamic_alpha=False)
        torch.cuda.synchronize()
        nlanes, err = hold_fold("bp_parallel", ker, ref, MINIMUM_SUM, f"single_scan/{alpha}")
        k1_err = max(k1_err, err)
        phase("single_scan_vs_plain", config=f"surface13/ms{alpha}", lanes=syn_k.shape[0],
              differing_lanes=nlanes, max_abs_err=err, converged=int(ker.converged.sum()))
    phase("golden_on_card", fixture=GOLDEN, configs=golden_on_card(), dtype="float64")
    fold_numbers = {}
    for name, kernel, args, extra in (
        ("bp_serial_time", "bp_serial",
         fold_args("bp_serial", tg, syn_all, llr0, MINIMUM_SUM, MS_FACTOR, MAX_ITER),
         {"schedule": "serial"}),
        ("bp_serial_relative_time", "bp_serial",
         fold_args("bp_serial", tg, syn_all, llr0, MINIMUM_SUM, MS_FACTOR, MAX_ITER, rel),
         {"schedule": "serial_relative"}),
        ("bp_soft_info_time", "bp_soft_info",
         fold_args("bp_soft_info", tg, scaled_soft(syn_np, torch.float32), llr0, MINIMUM_SUM,
                   MS_FACTOR, MAX_ITER), {}),
        ("bp_parallel_exact_time", "bp_parallel_exact",
         fold_args("bp_parallel_exact", tg, syn_all, llr0_64, MINIMUM_SUM, MS_FACTOR,
                   MAX_ITER), {}),
    ):
        numbers, err = time_fold(name, kernel, graph, args, **extra)
        fold_err[kernel] = max(fold_err[kernel], err)
        fold_numbers.setdefault(kernel, numbers)

    # ---- 5c. K9' (MBP over GF(4)) against its plain version, and timed ---------
    H4, hx4, hz4, mbp_syn = mbp_workload()
    g4 = mbp.gf4_to_torch(mbp.compile_gf4(H4), dev)
    n4 = H4.shape[1]
    mbp_syn_d = torch.from_numpy(mbp_syn).to(dev)
    params = {dt: mbp.mbp_params(np.full((3, n4), MBP_ERROR_RATE), np.ones((3, n4)), dt, dev)
              for dt in (torch.float64, torch.float32)}
    mbp_err = 0.0
    for mname, method in (("product_sum", PRODUCT_SUM), ("ms0.625", MINIMUM_SUM)):
        for dt in (torch.float64, torch.float32):
            mbp_err = max(mbp_err, compare_mbp(f"surface13/{mname}", g4,
                                               mbp_syn_d[:KERNEL_BATCH].contiguous(),
                                               *params[dt], method))
    # toric d=20 as [3 hz; hx]: a larger lane state
    hx20g, hz20g = (np.asarray(h.todense(), np.uint8) for h in (tor.hx, tor.hz))
    H20g = np.vstack([3 * hz20g, hx20g]).astype(np.uint8)
    g20g = mbp.gf4_to_torch(mbp.compile_gf4(H20g), dev)
    rng20 = np.random.default_rng(20)
    e20 = rng20.choice(4, size=(2048, H20g.shape[1]), p=[0.97, 0.01, 0.01, 0.01])
    syn20g = torch.from_numpy(mbp.pauli_syndrome(H20g, e20.astype(np.uint8)).astype(np.uint8))
    mbp_err = max(mbp_err, compare_mbp(
        "toric20/ms0.625", g20g, syn20g.to(dev), *mbp.mbp_params(
            np.full((3, H20g.shape[1]), MBP_ERROR_RATE), np.ones((3, H20g.shape[1])),
            torch.float64, dev), MINIMUM_SUM))

    def mbp_timed(method):
        """K9' at the MBP workload's call (16,384 lanes, float64): the plain
        version once, the kernel held against it, then timed; its float32
        instance timed beside it."""
        args = (g4, mbp_syn_d, *params[torch.float64], MAX_ITER, 0.0, method, MS_FACTOR)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        ref = mbp.mbp_reference(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        before = mbp_cuda.LAUNCHES
        ker = mbp_cuda.mbp_cuda(*args)
        torch.cuda.synchronize()
        launches = mbp_cuda.LAUNCHES - before
        nlanes, err = hold_mbp(ker, ref, "mbp_time")
        lane_iterations = int(ker[3].sum())
        moved = nbytes(mbp_syn_d, *params[torch.float64], g4.chk_bits, g4.chk_val, g4.var_chks,
                       g4.var_slot, g4.var_val, g4.lv_bits, g4.lv_ptr, *ker)
        bound_ms, bound_by = bound(moved, mbp_ops(g4, lane_iterations, method), F64_OPS_PER_S)
        ms = device_ms(lambda: mbp_cuda.mbp_cuda(*args))
        call_ms = cuda_ms(lambda: mbp_cuda.mbp_cuda(*args), 3)
        args32 = (g4, mbp_syn_d, *params[torch.float32]) + args[4:]
        float32_ms = device_ms(lambda: mbp_cuda.mbp_cuda(*args32))
        phase("mbp_time", config="min_sum" if method == MINIMUM_SUM else "product_sum",
              shape=f"B={mbp_syn_d.shape[0]},max_iter={MAX_ITER}", dtype="float64", ms=ms,
              call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
              ops_rate=f"float64:{F64_OPS_PER_S}", share_of_bound=bound_ms / ms,
              launches=launches, lane_iterations=lane_iterations, levels=g4.levels,
              converged=int(ker[2].sum()),
              differing_lanes=nlanes, max_abs_err=err, float32_ms=float32_ms)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}, err

    mbp_numbers, err = mbp_timed(MINIMUM_SUM)
    mbp_err = max(mbp_err, err, mbp_timed(PRODUCT_SUM)[1])

    # ---- 5d. K1''s float64 instance (single-scan) against its plain version ----
    ss_err = 0.0
    for alpha in (MS_FACTOR, 0.0):
        ref = bp_cuda.bp_parallel_reference(tg, syn_k, llr0_64, MINIMUM_SUM, MAX_ITER, alpha,
                                            dynamic_alpha=False)
        for state in ("shared", "device"):
            ker = bp_cuda.bp_parallel_cuda(tg, syn_k, llr0_64, MINIMUM_SUM, MAX_ITER, alpha,
                                           state=state, dynamic_alpha=False)
            torch.cuda.synchronize()
            nlanes, err = hold_fold("bp_parallel", ker, ref, MINIMUM_SUM,
                                    f"single_scan_f64/{alpha}/{state}")
            ss_err = max(ss_err, err)
            phase("single_scan_f64_vs_plain", config=f"surface13/ms{alpha}", state=state,
                  lanes=syn_k.shape[0], differing_lanes=nlanes, max_abs_err=err,
                  converged=int(ker.converged.sum()))

    def single_scan_64():
        return bp_cuda.bp_parallel_cuda(tg, syn_all, llr0_64, MINIMUM_SUM, MAX_ITER, MS_FACTOR,
                                        dynamic_alpha=False)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ref = bp_cuda.bp_parallel_reference(tg, syn_all, llr0_64, MINIMUM_SUM, MAX_ITER, MS_FACTOR,
                                        dynamic_alpha=False)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    before = bp_cuda.DTYPE_LAUNCHES["float64"]
    ker = single_scan_64()
    torch.cuda.synchronize()
    launches = bp_cuda.DTYPE_LAUNCHES["float64"] - before
    nlanes, err = hold_fold("bp_parallel", ker, ref, MINIMUM_SUM, "single_scan_f64_time")
    ss_err = max(ss_err, err)
    lane_iterations = int(ker.iterations.sum())
    bound_ms, bound_by = bound(nbytes(syn_all, llr0_64, tg.chk_bits_t, tg.var_edges_t, *ker),
                               k1_ops(graph, lane_iterations), F64_OPS_PER_S)
    ms = device_ms(single_scan_64)
    ss_numbers = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    phase("single_scan_f64_time", shape=f"B={syn_all.shape[0]},max_iter={MAX_ITER}",
          dtype="float64", ms=ms, call_ms=cuda_ms(single_scan_64, 3), plain_ms=plain_ms,
          bound_ms=bound_ms, bound_by=bound_by, ops_rate=f"float64:{F64_OPS_PER_S}",
          share_of_bound=bound_ms / ms, launches=launches, lane_iterations=lane_iterations,
          differing_lanes=nlanes, max_abs_err=err,
          state=bp_cuda.state_variant(tg.m, tg.n, tg.dc, torch.float64))

    # ---- 6. main paths: decode_batch -----------------------------------------
    paths = {p.key: p for p in decode_paths(code)}
    path = {key: drive_decoder(p, H, syn_np) for key, p in paths.items()}
    # K4' at the standalone UnionFind shape: every lane of the batch
    uf_dec = paths["uf_matrix"].make("cuda")
    uf_calls = captured_calls(gf2_cuda, "masked_solve", lambda: uf_dec.decode_batch(syn_np))
    elim_err["masked_solve"] = max(elim_err["masked_solve"],
                                   time_k4_calls("uf_matrix", uf_calls)["max_abs_err"])
    k4_residency(graph, {"lsd0": k4_calls, "uf_matrix": uf_calls})

    # ---- 6b. single-scan in float64: decode_single_scan, a syndrome a call -----
    ss_rows = syn_np[np.flatnonzero(syn_np.any(axis=1))[:SINGLE_SCAN_ROWS]]
    bp64 = dict(error_rate=ERROR_RATE, max_iter=MAX_ITER, ms_scaling_factor=MS_FACTOR,
                dtype="float64")
    reset_counters()
    d64 = ldpc_tpu_torch.BpDecoder(code.hx, device="cuda", **bp64)
    card = [(d64.decode_single_scan(s), d64.converge, d64.iter) for s in ss_rows]
    torch.cuda.synchronize()
    ss_counts = read_counters()
    if ss_counts["bp_parallel_float64"] != len(ss_rows):
        raise AssertionError(f"single-scan float64 skipped K1''s float64 instance: {ss_counts}")
    c64 = ldpc_tpu_torch.BpDecoder(code.hx, device="cpu", **bp64)
    for (x, conv, it), s in zip(card, ss_rows):
        if not ((c64.decode_single_scan(s) == x).all() and (c64.converge, c64.iter) == (conv, it)):
            raise AssertionError("decode_single_scan in float64 differs from the CPU")
    phase("single_scan_f64_path", rows=len(ss_rows), converged=sum(c for _, c, _ in card),
          bp_parallel_float64=ss_counts["bp_parallel_float64"], cpu_rows_equal=len(ss_rows))

    # ---- 6c. MbpDecoder: decode_batch and uf_decode ----------------------------
    reset_counters()
    mdec = make_mbp_decoder(H4, "cuda")
    t0 = time.perf_counter()
    mout = mdec.decode_batch(mbp_syn)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    mbp_counts = read_counters()
    if mbp_counts["mbp"] == 0:
        raise AssertionError(f"MbpDecoder skipped K9': {mbp_counts}")
    mconv, miters = mdec.converge_batch.copy(), mdec.iter_batch.copy()
    cand = np.concatenate([mbp.pauli_syndrome(H4, mout[i:i + 1024])
                           for i in range(0, len(mout), 1024)])
    if not (cand[mconv] == mbp_syn[mconv]).all():
        raise AssertionError("MbpDecoder: a converged row's Pauli syndrome differs from s")
    mcpu = make_mbp_decoder(H4, "cpu")
    out_cpu = mcpu.decode_batch(mbp_syn[:MBP_CPU_ROWS])
    if not ((out_cpu == mout[:MBP_CPU_ROWS]).all()
            and (mcpu.converge_batch == mconv[:MBP_CPU_ROWS]).all()
            and (mcpu.iter_batch == miters[:MBP_CPU_ROWS]).all()):
        raise AssertionError("MbpDecoder.decode_batch on the card differs from the CPU")
    mdec.decode_batch(mbp_syn)  # settle
    times = []
    for _ in range(SLICE_C_ROUNDS):
        t0 = time.perf_counter()
        mdec.decode_batch(mbp_syn)
        times.append(time.perf_counter() - t0)
    phase("decode_batch", config="MbpDecoder[min_sum]", syndromes=len(mbp_syn),
          warmup_s=round(warm_s, 3), median_s=statistics.median(times),
          syndromes_per_s=len(mbp_syn) / statistics.median(times),
          not_converged=int((~mconv).sum()), mean_iterations=float(miters.mean()),
          pauli_syndrome_rows=f"converged:{int(mconv.sum())}", cpu_rows_equal=MBP_CPU_ROWS,
          launches=json.dumps({k: v for k, v in mbp_counts.items() if v}))
    css = {d: ldpc_tpu_torch.MbpDecoder(
        HX_CSS=hx4, HZ_CSS=hz4, error_channel=np.full((3, n4), MBP_ERROR_RATE), max_iter=MAX_ITER,
        bp_method="min_sum", gamma_parameter=MS_FACTOR, device=d) for d in ("cuda", "cpu")}
    mz = hz4.shape[0]
    reset_counters()
    uf_out, uf_conv = [], 0
    with np.errstate(over="ignore", divide="ignore"):
        for s in mbp_syn[:UF_DECODE_ROWS]:
            ox, oz = css["cuda"].uf_decode(sx=s[:mz], sz=s[mz:])
            conv = css["cuda"].converge
            uf_out.append((ox, oz, None if conv else css["cuda"].log_prob_ratios.copy()))
            uf_conv += conv
        torch.cuda.synchronize()
        uf_counts = read_counters()
        # the CPU path from the card's MBP posteriors: the weights are
        # log-odds near 0 or 1 whose ulps the libraries' exp and log move,
        # and a weight's last bits may reorder a union-find growth
        uf_gap = 0.0
        for (ox, oz, lp), s in zip(uf_out, mbp_syn[:UF_DECODE_ROWS]):
            cx, cz = css["cpu"].decode(sx=s[:mz], sz=s[mz:])
            if css["cpu"].converge != (lp is None):
                raise AssertionError("MbpDecoder converges on the card and not on the CPU")
            if lp is not None:
                uf_gap = max(uf_gap, float(np.abs(css["cpu"].log_prob_ratios - lp).max()))
                wx, wz = mbp_decoder_mod.uf_weights(lp)
                cx = css["cpu"]._uf("x").decode(s[:mz], llrs=wx, bits_per_step=1)
                cz = css["cpu"]._uf("z").decode(s[mz:], llrs=wz, bits_per_step=1)
            if not ((cx == ox).all() and (cz == oz).all()):
                raise AssertionError("MbpDecoder.uf_decode on the card differs from the CPU")
            if not ((hz4 @ ox % 2 == s[:mz]).all() and (hx4 @ oz % 2 == s[mz:]).all()):
                raise AssertionError("MbpDecoder.uf_decode does not solve its syndromes")
    if uf_counts["mbp"] != UF_DECODE_ROWS or (uf_conv < UF_DECODE_ROWS
                                              and not uf_counts["masked_solve"]):
        raise AssertionError(f"uf_decode skipped a kernel: {uf_counts}")
    phase("mbp_uf_decode", rows=UF_DECODE_ROWS, mbp_converged=uf_conv,
          posterior_gap_to_cpu=uf_gap,
          hx_eq_s_rows=UF_DECODE_ROWS, cpu_rows_equal=UF_DECODE_ROWS,
          launches=json.dumps({k: v for k, v in uf_counts.items() if v}))

    # ---- 7. device Monte-Carlo -----------------------------------------------
    step, runs_per_call = mc_step(code, "cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    total = step(gen).cpu().numpy()  # warm-up
    times = []
    for _ in range(MC_CALLS):
        t0 = time.perf_counter()
        counters = step(gen).cpu().numpy()
        times.append(time.perf_counter() - t0)
        if counters[0] != runs_per_call:
            raise AssertionError(f"MC ran {counters[0]} of {runs_per_call}")
        total = total + counters
    phase(
        "device_mc", runs=int(total[0]), fails=int(total[1]),
        ler=float(total[1]) / float(total[0]), bp_converged=int(total[2]),
        osd_used=int(total[4]), bucket_overflow=int(total[5]),
        syndromes_per_s=runs_per_call / statistics.median(times),
    )

    # K2' at a Monte-Carlo bucket's shape: the first OSD-0 call of one step
    k2_bucket = captured_calls(gf2_cuda, "osd0", lambda: step(gen))[0]
    k2_err = max(k2_err, time_k2("k2_bucket_time", k2_bucket)[1])

    # ---- 8. one LSD statistics record: the card against the CPU ---------------
    make_lsd0 = paths["lsd0"].make
    probe = make_lsd0("cuda")
    probe.decode_batch(syn_np[:STATS_ROWS])
    row = int(np.flatnonzero(~probe.converge_batch)[0])  # a row LSD decodes
    card = stats_record(make_lsd0, syn_np[:STATS_ROWS], row, "cuda")
    host = stats_record(make_lsd0, syn_np[:STATS_ROWS], row, "cpu")
    phase("lsd_stats", row=row, clusters=len(card["individual_cluster_stats"]),
          timesteps=len(card["global_timestep_bit_history"]), equal_to_cpu=card == host)
    if card != host or not card["individual_cluster_stats"]:
        raise AssertionError("LSD statistics on the card differ from the CPU's")

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ldpc_tpu"))
    if imported:
        raise AssertionError(f"the port imported the JAX side: {imported}")

    # No PyTorch call computes BP (any schedule), a GF(2) elimination or a
    # flip sweep in one call, so library_ms is null on every kernel.
    # variant_launches: the main path's launches by variant (K1' by where a
    # lane's state lived; K2'-K5' warp, block or device; flip has one design,
    # a warp scanning a lane)
    def entry(name, source, replaces, counts, err, numbers, variants):
        return {"name": name, "route": "cuda", "source": f"ldpc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts[name], "max_abs_err": err,
                **numbers, "library_ms": None,
                "variant_launches": {v: counts[k] for v, k in variants.items()}}

    def elim_variants(name):
        return {v: f"{name}_{v}" for v in ELIM_VARIANTS}

    def fold_states(name):
        return {v: f"{name}_{v}_state" for v in ("shared", "device")}

    print(json.dumps({"kernels": [
        entry("bp_parallel", "bp_parallel.cu", "ldpc_tpu/ops/bp_pallas.py:69",
              path["osd0"], k1_err, k1_numbers,
              {"shared": "bp_shared_state", "device": "bp_device_state"}),
        # K1''s float64 instance on its path: single-scan, a syndrome a call
        entry("bp_parallel", "bp_parallel.cu", "ldpc_tpu/ops/bp_pallas.py:69",
              ss_counts | {"bp_parallel": ss_counts["bp_parallel_float64"]}, ss_err, ss_numbers,
              {"shared": "bp_shared_state", "device": "bp_device_state"})
        | {"name": "bp_parallel[float64]", "dtype": "float64",
           "main_path": "BpDecoder(dtype=float64).decode_single_scan"},
        entry("osd0", "gf2_elim.cu", "ldpc_tpu/ops/gf2_pallas.py:46",
              path["osd0"], k2_err, k2_numbers, elim_variants("osd0")),
        entry("rref_export", "gf2_elim.cu", "ldpc_tpu/ops/gf2_pallas.py:363",
              path["osd_cs5"], elim_err["rref_export"],
              elim_numbers["rref_export"], elim_variants("rref_export")),
        entry("masked_solve", "gf2_elim.cu", "ldpc_tpu/ops/gf2_pallas.py:163",
              path["lsd0"], elim_err["masked_solve"],
              elim_numbers["masked_solve"], elim_variants("masked_solve")),
        entry("masked_export", "gf2_elim.cu", "ldpc_tpu/ops/gf2_pallas.py:445",
              path["lsd_cs5"], elim_err["masked_export"],
              elim_numbers["masked_export"], elim_variants("masked_export")),
        entry("flip", "flip.cu", "ldpc_tpu/ops/flip.py:22", path["flip"], flip_err,
              flip_numbers, {"warp_per_lane_scan": "flip"}),
        entry("bp_serial", "bp_fold.cu", "ldpc_tpu/ops/bp.py:496", path["osd0_serial"],
              fold_err["bp_serial"], fold_numbers["bp_serial"], fold_states("bp_serial"))
        | {"launches_serial_relative": path["osd0_serial_relative"]["bp_serial"]},
        entry("bp_soft_info", "bp_fold.cu", "ldpc_tpu/ops/bp.py:349", path["soft_osd0"],
              fold_err["bp_soft_info"], fold_numbers["bp_soft_info"], fold_states("bp_soft_info")),
        entry("bp_parallel_exact", "bp_exact.cu", "ldpc_tpu/ops/bp.py:251", path["osd0_f64"],
              fold_err["bp_parallel_exact"], fold_numbers["bp_parallel_exact"],
              fold_states("bp_parallel_exact")),
        entry("mbp", "mbp.cu", "ldpc_tpu/ops/mbp.py:79", mbp_counts, mbp_err, mbp_numbers,
              {"float32": "mbp_float32", "float64": "mbp_float64"})
        | {"main_path": "MbpDecoder.decode_batch"},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
