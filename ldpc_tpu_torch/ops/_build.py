"""Build the port's CUDA kernels with nvcc and load them through ctypes.

At first use every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``)
into one shared library with a plain C interface, under
``build/ldpc_tpu_torch/`` beside the package. The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. A failed build raises with
nvcc's error output. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ldpc_tpu_torch"

# -fmad=false: no fused multiply-add contraction, so the kernels round
# every operation where their plain PyTorch versions do
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (syndromes_t, llr0, chk_bits, var_edges, m, n, dc, dv, B, max_iter,
    #  min_sum, ms_scaling, c2v, llr, dec, conv, iters, stream)
    "ldpc_bp_parallel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _P, _P, _P, _P, _P, _P],
    # (syndromes, order, packed_h, m, n, Wp, rank, B, x0, valid, stream)
    "ldpc_osd0": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # ptxas's register and shared-memory report of the last build


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


def _build() -> Path:
    global build_log
    out = BUILD_DIR / f"libldpc_tpu_torch_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    build_log = proc.stderr
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
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
