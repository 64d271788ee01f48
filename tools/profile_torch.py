"""Profile ``decode_batch`` of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: ``python tools/profile_torch.py [--out PATH]``
from the repository root, on a machine with a CUDA device and ``nvcc``.

The workload and the configurations are ``chip_smoke.py``'s, imported
from it (``main_workload``, ``decode_paths``, ``mc_step``): every
``decode_batch`` configuration decodes the same 65,536 d=13 surface-code
syndromes (soft-information BP their soft versions), ``MbpDecoder`` the
16,384 depolarizing syndromes of ``mbp_workload``, the device
Monte-Carlo step runs 16,384 x 8 rounds, the window decoder decodes the
histories of ``window_history`` in each of ``WINDOW_CONFIGS`` (rates in
round-syndromes/s), the QSS step runs one call of 8,192 shots, binary
and analog (rates in shots/s), and the overlapping-window decoders decode
the DEM shots of ``owd_workload``: BP+OSD-0 through the device windows and
through the forced host loop on 8,192 shots, BP+LSD-0 through the device
windows on 1,024 (rates in shots/s). For
each: two warm-up calls, the median of three unprofiled calls,
then one call under ``torch.profiler`` (CPU and CUDA activities). From the
profiler's trace: the device's busy time, the union of its kernel, copy and
memset intervals; the idle share, 1 - busy / the profiled call's wall time
(the profiler inflates that wall, so the idle share is an upper bound); the
device time of each kernel name with its launch count; and each launch of
the port's own kernels. One line per configuration goes to stdout and the
whole record, with the card's name and power limit, to ``--out`` as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OWN_KERNELS = ("bp_warp_kernel", "gf2_warp_osd0_kernel", "gf2_warp_export_kernel",
               "gf2_warp_solve_kernel", "gf2_block_kernel", "flip_kernel", "fold_kernel",
               "exact_kernel", "mbp_kernel")


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_events(prof):
    """The profiled window's device-side events from its chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def profile_call(call, unprofiled_calls: int = 3) -> dict:
    """Warm ``call`` up, time it unprofiled, then profile one call."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(unprofiled_calls):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in events]) / 1e3
    by_name = {}
    own = []
    for e in events:
        name = e["name"]
        short = next((k for k in OWN_KERNELS if k in name), name[:70])
        total, count = by_name.get(short, (0.0, 0))
        by_name[short] = (total + e["dur"] / 1e3, count + 1)
        if short in OWN_KERNELS:
            own.append({"kernel": short, "ms": e["dur"] / 1e3,
                        "grid": e.get("args", {}).get("grid")})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "unprofiled_ms": statistics.median(walls) * 1e3,
        "unprofiled_all_ms": [w * 1e3 for w in walls],
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if events else None,
        "device_events": len(events),
        "by_kernel": [{"name": k, "ms": v[0], "launches": v[1]} for k, v in top],
        "own_launches": own,
    }


def report(record: dict, name: str, out: dict) -> None:
    """Keep ``out`` under ``name`` and print its line."""
    record["configs"][name] = out
    top = ", ".join(f"{k['name']} {k['ms']:.3f} ms x{k['launches']}" for k in out["by_kernel"][:5])
    print(f"[profile] config={name} unprofiled_ms={out['unprofiled_ms']} "
          f"syndromes_per_s={out['syndromes_per_s']} profiled_wall_ms={out['profiled_wall_ms']} "
          f"device_busy_ms={out['device_busy_ms']} idle_share={out['idle_share']} "
          f"top=[{top}]", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/profile_torch.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    code, _, syn = chip_smoke.main_workload()
    record = {"card": card, "torch": torch.__version__, "syndromes": len(syn), "configs": {}}
    for p in chip_smoke.decode_paths(code):
        dec = p.make("cuda")
        x = syn if p.inputs is None else p.inputs(syn)
        out = profile_call(lambda: dec.decode_batch(x, *p.args))
        out["syndromes_per_s"] = len(syn) / (out["unprofiled_ms"] / 1e3)
        report(record, p.label, out)
    H4, _, _, mbp_syn = chip_smoke.mbp_workload()
    mdec = chip_smoke.make_mbp_decoder(H4, "cuda")
    out = profile_call(lambda: mdec.decode_batch(mbp_syn))
    out["syndromes_per_s"] = len(mbp_syn) / (out["unprofiled_ms"] / 1e3)
    report(record, "MbpDecoder[min_sum]", out)
    step, runs = chip_smoke.mc_step(code, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = profile_call(lambda: step(gen).cpu())
    out["syndromes_per_s"] = runs / (out["unprofiled_ms"] / 1e3)
    report(record, "device_mc", out)
    for label, analog, post, rows in chip_smoke.WINDOW_CONFIGS:
        hist, ana, _ = chip_smoke.window_history(code, rows, analog)
        wdec = chip_smoke.make_window(code, "cuda", analog, post)
        out = profile_call(lambda: wdec(hist, ana).correction.cpu())
        out["syndromes_per_s"] = rows * chip_smoke.WINDOW_ROUNDS / (out["unprofiled_ms"] / 1e3)
        report(record, f"window[{label}]", out)
    for analog in (False, True):
        qstep, qruns = chip_smoke.make_qss_step(
            code.hx, chip_smoke.QSS_P, chip_smoke.QSS_P, code.lx,
            repetitions=chip_smoke.WINDOW_REPS, rounds=chip_smoke.WINDOW_ROUNDS,
            batch_size=chip_smoke.QSS_BATCH, max_iter=chip_smoke.QSS_ITERS,
            ms_scaling_factor=chip_smoke.MS_FACTOR, analog_tg=analog, device="cuda")
        out = profile_call(lambda: qstep(gen).cpu())
        out["syndromes_per_s"] = qruns / (out["unprofiled_ms"] / 1e3)
        report(record, f"qss[{'analog' if analog else 'binary'}]", out)
    for label, cls, rows, scan in (
            ("bposd", chip_smoke.ckt_noise.BpOsdOverlappingWindowDecoder, chip_smoke.OWD_BATCH, True),
            ("bposd_host_loop", chip_smoke.ckt_noise.BpOsdOverlappingWindowDecoder,
             chip_smoke.OWD_BATCH, False),
            ("lsd", chip_smoke.ckt_noise.LsdOverlappingWindowDecoder, chip_smoke.OWD_LSD_BATCH, True)):
        dem, _, shots, _ = chip_smoke.owd_workload(code, rows)
        odec = chip_smoke.make_owd(cls, dem, "cuda")
        if not scan:
            odec._device_scan = None
        out = profile_call(lambda: odec.decode_batch(shots))
        out["syndromes_per_s"] = rows / (out["unprofiled_ms"] / 1e3)
        report(record, f"owd[{label}]", out)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
