"""Drive the PyTorch/CUDA port (``ldpc_tpu_torch``) once on one NVIDIA GPU.

Usage: ``python chip_smoke.py`` from the repository root, on a machine with
a CUDA device, ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``) and
PyTorch built for CUDA. It builds the kernels from ``ldpc_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, drives the
BP+OSD-0 main path through ``BpOsdDecoder.decode_batch`` and the device
Monte-Carlo step at the d=13 surface-code workload, and checks the outputs.
Every phase prints one line; any failure raises and exits non-zero. The
second-to-last line is a JSON object describing each kernel; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import ldpc_tpu_torch
from ldpc_tpu_torch.codes import surface_code, toric_code
from ldpc_tpu_torch.monte_carlo_simulation import make_mc_decoder_step
from ldpc_tpu_torch.ops import _build, bp_cuda, gf2, gf2_cuda
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, PRODUCT_SUM, channel_llr
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch

DISTANCE = 13
ERROR_RATE = 0.01
MAX_ITER = 30
MS_FACTOR = 0.625
BATCH = 65536  # the host-boundary workload (numpy seed 7)
KERNEL_BATCH = 8192  # kernel-vs-plain comparisons
CPU_ROWS = 4096  # rows also decoded on the CPU and compared
TIMED_ROUNDS = 7
MC_BATCH = 16384
MC_ROUNDS = 8
MC_CALLS = 3


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


def workload(H: np.ndarray, rows: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    errors = (rng.random((rows, H.shape[1])) < ERROR_RATE).astype(np.uint8)
    return errors, (errors @ H.T % 2).astype(np.uint8)


def compare_bp(name, tg, syn, llr0, method, alpha):
    ker = bp_cuda.bp_parallel_cuda(tg, syn, llr0, method, MAX_ITER, alpha)
    ref = bp_cuda.bp_parallel_reference(tg, syn, llr0, method, MAX_ITER, alpha)
    torch.cuda.synchronize()
    lane_diff = (
        (ker.decoding != ref.decoding).any(dim=1)
        | (ker.converged != ref.converged)
        | (ker.iterations != ref.iterations)
    )
    nlanes = int(lane_diff.sum())
    err = float((ker.llr_posterior - ref.llr_posterior).abs().max())
    phase(
        "k1_vs_plain", config=name, lanes=syn.shape[0], differing_lanes=nlanes,
        max_abs_err=err, converged=int(ker.converged.sum()),
    )
    if method == MINIMUM_SUM:
        # same operations in the same order on both sides: bit-exact
        if nlanes or err != 0.0:
            raise AssertionError(f"K1' min-sum differs from its plain version: {name}")
    elif not torch.allclose(ker.llr_posterior, ref.llr_posterior, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"K1' product-sum posteriors beyond rtol 1e-4: {name}")
    return ker, err


def compare_osd(name, tg, H, syn, llr, rank):
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()
    x_k, v_k = gf2_cuda.osd0_cuda(tg, syn, order, rank)
    x_r, v_r = gf2_cuda.osd0_reference(tg, syn, order, rank)
    torch.cuda.synchronize()
    nlanes = int(((x_k != x_r).any(dim=1) | (v_k != v_r)).sum())
    err = int((x_k.int() - x_r.int()).abs().max()) if syn.shape[0] else 0
    x = x_k.cpu().numpy()
    s = syn.cpu().numpy()
    valid = v_k.cpu().numpy()
    solves = ((x @ H.T) % 2 == s).all(axis=1)
    phase(
        "k2_vs_plain", config=name, lanes=syn.shape[0], differing_lanes=nlanes,
        valid=int(valid.sum()), solves_on_valid=bool(solves[valid].all()),
    )
    if nlanes or err:
        raise AssertionError(f"K2' differs from its plain version: {name}")
    if not solves[valid].all():
        raise AssertionError(f"K2' x0 does not solve H x = s on a valid lane: {name}")
    return err


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
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    code = surface_code(DISTANCE, compute_logicals=True)
    H = np.asarray(code.hx.todense(), np.uint8)
    graph = compile_pcm(code.hx)
    tg = graph_to_torch(graph, dev)
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, ERROR_RATE))).to(dev)
    _, syn_np = workload(H, BATCH)
    syn_all = torch.from_numpy(syn_np).to(dev)
    syn_k = syn_all[:KERNEL_BATCH].contiguous()

    tor = toric_code(20)
    H20 = np.asarray(tor.hx.todense(), np.uint8)
    graph20 = compile_pcm(tor.hx)
    tg20 = graph_to_torch(graph20, dev)
    llr20 = torch.from_numpy(channel_llr(np.full(graph20.n, ERROR_RATE))).to(dev)
    syn20 = torch.from_numpy(workload(H20, KERNEL_BATCH)[1]).to(dev)

    # ---- 3. K1' against its plain version ------------------------------------
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

    # times at the main path's largest K1' call: phase-1 BP on the whole batch
    def k1_kernel():
        bp_cuda.bp_parallel_cuda(tg, syn_all, llr0, MINIMUM_SUM, 6, MS_FACTOR)

    def k1_plain():
        bp_cuda.bp_parallel_reference(tg, syn_all, llr0, MINIMUM_SUM, 6, MS_FACTOR)

    k1_ms = cuda_ms(k1_kernel, 5)
    k1_plain_ms = cuda_ms(k1_plain, 3)
    phase("k1_time", shape=f"B={BATCH},max_iter=6", ms=k1_ms, plain_ms=k1_plain_ms)

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
    k2_ms = cuda_ms(lambda: gf2_cuda.osd0_cuda(tg, syn_f, order_f, rank13), 5)
    k2_plain_ms = cuda_ms(lambda: gf2_cuda.osd0_reference(tg, syn_f, order_f, rank13), 2)
    phase("k2_time", shape=f"B={failed.numel()}", ms=k2_ms, plain_ms=k2_plain_ms)

    # ---- 5. main path: BpOsdDecoder.decode_batch -------------------------------
    def decoder(device):
        return ldpc_tpu_torch.BpOsdDecoder(
            code.hx, error_rate=ERROR_RATE, max_iter=MAX_ITER,
            bp_method="minimum_sum", ms_scaling_factor=MS_FACTOR,
            osd_method="osd_0", device=device,
        )

    bp_cuda.LAUNCHES = 0
    gf2_cuda.LAUNCHES = 0
    dec = decoder("cuda")
    t0 = time.perf_counter()
    out = dec.decode_batch(syn_np)  # warm-up
    warm_s = time.perf_counter() - t0
    if not ((out.astype(np.int64) @ H.T) % 2 == syn_np).all():
        raise AssertionError("decode_batch output does not satisfy H x = s")
    if bp_cuda.LAUNCHES == 0 or gf2_cuda.LAUNCHES == 0:
        raise AssertionError(
            f"main path skipped a kernel: K1' {bp_cuda.LAUNCHES}, K2' {gf2_cuda.LAUNCHES}"
        )
    conv, iters = dec.converge_batch.copy(), dec.iter_batch.copy()
    cpu = decoder("cpu")
    out_cpu = cpu.decode_batch(syn_np[:CPU_ROWS])
    if not (
        (out_cpu == out[:CPU_ROWS]).all()
        and (cpu.converge_batch == conv[:CPU_ROWS]).all()
        and (cpu.iter_batch == iters[:CPU_ROWS]).all()
    ):
        raise AssertionError("decode_batch on the card differs from the CPU")
    dec.decode_batch(syn_np)  # settle
    times = []
    for _ in range(TIMED_ROUNDS):
        t0 = time.perf_counter()
        dec.decode_batch(syn_np)
        times.append(time.perf_counter() - t0)
    rate = BATCH / statistics.median(times)
    phase(
        "decode_batch", syndromes=BATCH, warmup_s=round(warm_s, 3),
        median_s=statistics.median(times), syndromes_per_s=rate,
        bp_failed_full_depth=int((~conv).sum()), cpu_rows_equal=CPU_ROWS,
    )

    # ---- 6. device Monte-Carlo -----------------------------------------------
    step, runs_per_call = make_mc_decoder_step(
        code.hx, ERROR_RATE, logicals=code.lx, batch_size=MC_BATCH,
        rounds_per_call=MC_ROUNDS, max_iter=MAX_ITER,
        ms_scaling_factor=MS_FACTOR, device="cuda",
    )
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
    launches = {"bp_parallel": bp_cuda.LAUNCHES, "osd0": gf2_cuda.LAUNCHES}
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": [
        {"name": "bp_parallel", "route": "cuda",
         "source": "ldpc_tpu_torch/csrc/bp_parallel.cu",
         "replaces": "ldpc_tpu/ops/bp_pallas.py:69",
         "launches": launches["bp_parallel"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "osd0", "route": "cuda",
         "source": "ldpc_tpu_torch/csrc/osd0.cu",
         "replaces": "ldpc_tpu/ops/gf2_pallas.py:46",
         "launches": launches["osd0"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
