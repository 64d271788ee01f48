"""Build the port's CUDA kernels with nvcc and load them through ctypes.

At first use every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``),
one nvcc process per source, all started together, and the objects are
linked into one shared library with a plain C interface, under
``build/ldpc_tpu_torch/`` beside the package. The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. ptxas's register and spill report
is written beside the library and read back when the library is loaded
from there. A failed build raises with nvcc's error output. Nothing here
runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ldpc_tpu_torch"

# -fmad=false: no fused multiply-add contraction, so the kernels round
# every operation where their plain PyTorch versions do
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # (syndromes, llr0, chk_bits_t, var_edges_t, m, n, dc, dv, B, max_iter,
    #  min_sum, ms_scaling, dynamic_alpha, shared, f64, c2v, post, dec, conv,
    #  iters, stream)
    "ldpc_bp_parallel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _D, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # (m, n, dc, elem bytes) -> 1 when K1 keeps a lane's state in shared memory
    "ldpc_bp_shared_state": [_I, _I, _I, _I],
    # (kernel: 0 K3', 1 K4', 2 K5', 3 K2'; m, n) -> the variant it takes by
    # default: 0 warp, 1 block, 2 device
    "ldpc_elim_variant": [_I, _I, _I],
    # (m, cap_words) -> warps of K4's warp variant resident on an SM
    "ldpc_masked_solve_resident_warps": [_I, _I],
    # (syndromes, order, packed_h, var_chks, m, n, Wp, dv, rank, B, variant,
    #  x0, valid, scratch, stream)
    "ldpc_osd0": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # (syndromes, order, packed_h, m, n, Wp, rank, B, variant, M, col_of_row,
    #  used, stream)
    "ldpc_rref_export": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # (syndromes, order, count, packed_h, var_chks, m, n, Wp, dv, B, variant,
    #  x0, bad_row, scratch, stream)
    "ldpc_masked_solve": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # (syndromes, order, count, packed_h, m, n, Wp, B, variant, M,
    #  col_of_row, used, stream)
    "ldpc_masked_export": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # (engine: 0 K6', 1 K7', 2 K8'; m, n, dc, dv, elem bytes, relative) -> 1
    # when the fold engines keep a lane's state in shared memory
    "ldpc_bp_fold_shared_state": [_I, _I, _I, _I, _I, _I, _I],
    # (m, n) -> bytes of a lane's serial-relative arrays
    "ldpc_bp_serial_relative_bytes": [_I, _I],
    # (syndromes, llr0, chk_bits, var_edges, var_chks, lv_bits, lv_ptr, m, n,
    #  dc, dv, B, max_iter, order_mode, min_sum, f64, ms_scaling, shared, msg,
    #  rel, post, dec, conv, iters, prof, stream)
    "ldpc_bp_serial": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _D, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # (soft, llr0, chk_bits, var_edges, var_chks, lv_bits, lv_ptr, m, n, dc,
    #  dv, B, max_iter, f64, ms_scaling, cutoff, shared, msg, synd, post, dec,
    #  soft_out, conv, iters, prof, stream)
    "ldpc_bp_soft_info": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _D, _D, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # (syndromes, llr0, chk_bits_t, var_edges_t, m, n, dc, dv, B, max_iter,
    #  min_sum, ms_scaling, shared, msg, post, dec, conv, iters, next, prof,
    #  stream)
    "ldpc_bp_parallel_exact": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _D, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # (m, n, dc) -> bytes of shared memory a K8' lane takes
    "ldpc_bp_exact_lane_bytes": [_I, _I, _I],
    # (m, n, dc, dv, min_sum, shared) -> K8' lanes resident on an SM
    "ldpc_bp_exact_resident_lanes": [_I, _I, _I, _I, _I, _I],
    # (syndromes, chan, inv_alpha, chk_bits, chk_val, var_chks, var_slot,
    #  var_val, lv_bits, lv_ptr, levels, pairs, m, n, dc, dv, B, max_iter,
    #  min_sum, f64, beta, gamma, cache, msg, llr, dec, conv, iters, stream)
    "ldpc_mbp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                 _I, _I, _I, _I, _I, _D, _D, _P, _P, _P, _P, _P, _P, _P],
    # (m, n, dv) -> bytes of shared memory a block of the flip sweep takes
    "ldpc_flip_smem": [_I, _I, _I],
    # (syndromes, var_chks, m, n, dv, B, max_iter, pfreq, seed, dec, conv,
    #  iters, stream)
    "ldpc_flip": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_uint, _P, _P, _P,
                  _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # ptxas's register and shared-memory report of the library


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run nvcc commands concurrently; raise with the first failure's output."""
    cmds = list(cmds)
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in cmds
    ]
    outs = [p.communicate() for p in procs]  # waits for every process
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {p.returncode}:\n"
                f"{' '.join(cmd)}\n{err}{out}"
            )
    return "".join(err for _, err in outs)


def _build() -> Path:
    global build_log
    out = BUILD_DIR / f"libldpc_tpu_torch_{_digest()}.so"
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        build_log = report.read_text() if report.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        log = _run(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)
        )
        lib = Path(tmp) / out.name
        _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(lib), *map(str, objs)]])
        report.write_text(log)
        # atomic: concurrent builders never see half a file
        os.replace(lib, out)
    build_log = log
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ldpc_error_string.argtypes = [ctypes.c_int]
            lib.ldpc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.ldpc_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
