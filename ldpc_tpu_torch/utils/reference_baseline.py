"""Build + drive the compiled reference decoder as a baseline oracle
(the port's own copy of ``ldpc_tpu.utils.reference_baseline``).

Drives the reference C++ implementation wherever a tool or test needs it
(a throughput baseline, matched per-family baselines, LER-parity checks):
compiles ``native/bench_baseline.cpp`` against the read-only reference
headers and streams workloads through it.

The reference tree is read only from the directory that
``LDPC_REFERENCE_DIR`` names; there is no default. Without the variable
(or without ``g++``) :func:`available` is False and nothing here runs. The binary is built under the system's
temporary directory.

The reference's ``mbp.hpp`` does not compile against its own
``sparse_matrix_base.hpp`` (it calls ``iterate_column_ptr``/
``iterate_row_ptr``, which exist nowhere in the tree, and the reference's
setup.py consequently omits the mbp extension from ``cpp_modules``).  To
execute the reference MBP at all, :func:`_patched_include_dir` writes a
copy of ``mbp.hpp`` with the two pointer-yielding iterators restored
(built from the linked-list iterators the header was written against) to
a temp include dir that shadows the original.  Nothing under the
reference tree is modified.
"""

import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF = os.environ.get("LDPC_REFERENCE_DIR")
_BUILD_DIR = os.path.join(tempfile.gettempdir(), "ldpc_tpu_torch_baseline")
BIN = os.path.join(_BUILD_DIR, "bench_baseline")

_MBP_SHIM = """
    std::vector<mbp_entry<uint8_t>*> iterate_column_ptr(int i) {
        std::vector<mbp_entry<uint8_t>*> out;
        for (auto &e : BASE::iterate_column(i)) out.push_back(&e);
        return out;
    }
    std::vector<mbp_entry<uint8_t>*> iterate_row_ptr(int i) {
        std::vector<mbp_entry<uint8_t>*> out;
        for (auto &e : BASE::iterate_row(i)) out.push_back(&e);
        return out;
    }
"""


def _patched_include_dir() -> str:
    """Shadow include dir holding the iterator-restored mbp.hpp."""
    inc = os.path.join(_BUILD_DIR, "patched_include")
    os.makedirs(inc, exist_ok=True)
    dst = os.path.join(inc, "mbp.hpp")
    if not os.path.exists(dst):
        src = open(os.path.join(REF, "src_cpp", "mbp.hpp")).read()
        anchor = "~mbp_sparse() = default;"
        patched = src.replace(anchor, anchor + "\n" + _MBP_SHIM, 1)
        if patched == src:  # anchor moved: fail loudly, not silently
            raise RuntimeError("mbp.hpp anchor not found; update the shim")
        open(dst, "w").write(patched)
    return inc


def available() -> bool:
    import shutil

    return (
        REF is not None
        and os.path.isdir(os.path.join(REF, "src_cpp"))
        and shutil.which("g++") is not None
    )


def build_binary() -> Optional[str]:
    """Compile the driver once per process tree; None when unavailable.
    A binary older than the driver source is rebuilt."""
    src = os.path.join(_REPO, "native", "bench_baseline.cpp")
    if os.path.exists(BIN) and os.path.getmtime(BIN) >= os.path.getmtime(src):
        return BIN
    if not available():
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        "g++", "-O3", "-std=c++20", "-o", BIN, src,
        "-I", _patched_include_dir(),
        "-I", os.path.join(REF, "src_cpp"),
        "-I", os.path.join(REF, "include"),
        "-I", os.path.join(REF, "include", "robin_map"),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except Exception:
        return None
    return BIN


def make_input(
    H: np.ndarray,
    channel: Sequence[float],
    syndromes: np.ndarray,
    channel3: Optional[np.ndarray] = None,
    soft_syndromes: Optional[np.ndarray] = None,
) -> str:
    """Serialize a workload to the driver's stdin format. ``channel3``
    ((3, n), mbp mode) replaces ``channel``; ``soft_syndromes``
    ((B, m) float, softinfo mode) replaces ``syndromes``."""
    m, n = H.shape
    lines = [f"{m} {n}"]
    lines += [" ".join(map(str, row)) for row in np.asarray(H)]
    if channel3 is not None:
        for w in range(3):
            lines.append(" ".join(f"{p:.10f}" for p in channel3[w]))
    else:
        lines.append(" ".join(f"{p:.10f}" for p in channel))
    if soft_syndromes is not None:
        lines.append(str(len(soft_syndromes)))
        lines += [
            " ".join(f"{v:.10f}" for v in s) for s in soft_syndromes
        ]
    else:
        lines.append(str(len(syndromes)))
        lines += [" ".join(map(str, s)) for s in np.asarray(syndromes)]
    return "\n".join(lines)


def run(
    stdin: str,
    max_iter: int = 30,
    ms_factor: float = 0.625,
    osd_method: int = 0,
    osd_order: int = 0,
    dump: bool = False,
    decoder: str = "osd",
    extra1: float = 0.0,
    extra2: float = 0.0,
    timeout: int = 1800,
):
    """One driver run. Returns ``(seconds, decodings-or-None)``."""
    binary = build_binary()
    if binary is None:
        raise RuntimeError("reference baseline unavailable")
    out = subprocess.run(
        [
            binary,
            str(max_iter),
            str(ms_factor),
            str(osd_method),
            str(osd_order),
            "1" if dump else "0",
            decoder,
            str(extra1),
            str(extra2),
        ],
        input=stdin,
        capture_output=True,
        text=True,
        check=True,
        timeout=timeout,
    ).stdout.splitlines()
    secs = float(out[0].split(" in ")[1].split(" s")[0])
    if not dump:
        return secs, None
    rows = [
        np.frombuffer(line.encode(), np.uint8) - ord("0")
        for line in out[1:]
        if line
    ]
    return secs, np.stack(rows).astype(np.uint8)


def best_rate(
    stdin: str,
    num_syndromes: int,
    reps: int = 5,
    **kw,
) -> float:
    """Best-of-``reps`` syndromes/s (the single-core C++ rate dips under
    concurrent host load; the fastest run is the honest baseline)."""
    best = None
    for _ in range(reps):
        secs, _ = run(stdin, dump=False, **kw)
        best = secs if best is None else min(best, secs)
    return num_syndromes / best
