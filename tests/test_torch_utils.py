"""The port's utilities (``ldpc_tpu_torch.utils``) on the CPU: the stage
timer, ``annotate`` and ``trace`` (a non-empty Chrome trace),
``profile_decode`` on a port decoder, and ``reference_baseline``, whose
input serialisation must equal the JAX package's byte for byte. The cases
that drive the compiled reference skip where it is unavailable, as
tests/test_ler_parity.py does.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from ldpc_tpu.utils import reference_baseline as jax_rb
from ldpc_tpu_torch import BpOsdDecoder
from ldpc_tpu_torch.codes import rep_code
from ldpc_tpu_torch.utils import StageTimer, annotate, profile_decode, trace
from ldpc_tpu_torch.utils import reference_baseline as rb


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("a"):
        x = sum(range(1000))
    with t.stage("a"):
        x += sum(range(1000))
    with t.stage("b", fence_output=False):
        pass
    rep = t.report()
    assert set(rep) == {"a", "b"}
    assert t.counts["a"] == 2 and rep["a"] >= 0.0
    assert "a" in t.pretty() and "ms" in t.pretty()
    y = torch.arange(4)
    assert t.fence(y) is y
    assert x > 0


def test_annotate_and_trace(tmp_path):
    with trace(str(tmp_path)):
        with annotate("square"):
            y = torch.arange(8.0) ** 2
    assert float(y[3]) == 9.0
    files = [f for f in os.scandir(tmp_path) if f.name.endswith(".json")]
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(open(files[0].path).read())["traceEvents"]
    assert any(e.get("name") == "square" for e in events)


def test_annotate_as_decorator():
    @annotate("twice")
    def twice(v):
        return 2 * v

    assert twice(3) == 6


def test_profile_decode_reports_stages(tmp_path):
    H = rep_code(20)
    dec = BpOsdDecoder(H, error_rate=0.05, max_iter=10, bp_method="ms", osd_order=0,
                       device="cpu")
    rng = np.random.default_rng(0)
    errors = (rng.random((64, 20)) < 0.05).astype(np.uint8)
    syn = (errors @ np.asarray(H.todense()).T % 2).astype(np.uint8)
    rep = profile_decode(dec, syn, repeats=2, log_dir=str(tmp_path))
    assert rep["compile"] > 0 and rep["decode"] > 0
    assert rep["syndromes_per_sec"] > 0
    assert any(f.stat().st_size > 0 for f in os.scandir(tmp_path))


MAKE_INPUT_CASES = {
    "syndromes": lambda H, rng: dict(channel=rng.random(H.shape[1]) * 0.1,
                                     syndromes=rng.integers(0, 2, (5, H.shape[0]))),
    "mbp": lambda H, rng: dict(channel=None, syndromes=rng.integers(0, 2, (3, H.shape[0])),
                               channel3=rng.random((3, H.shape[1])) * 0.05),
    "soft": lambda H, rng: dict(channel=np.full(H.shape[1], 0.01), syndromes=None,
                                soft_syndromes=rng.standard_normal((4, H.shape[0]))),
}


@pytest.mark.parametrize("case", list(MAKE_INPUT_CASES))
def test_make_input_matches_jax_byte_for_byte(case):
    H = np.asarray(rep_code(9).todense(), np.uint8)
    kw = MAKE_INPUT_CASES[case](H, np.random.default_rng(4))
    assert rb.make_input(H, **kw).encode() == jax_rb.make_input(H, **kw).encode()


def test_reference_location():
    assert rb.REF == os.environ.get("LDPC_REFERENCE_DIR")
    assert rb.available() == (rb.REF is not None
                              and os.path.isdir(os.path.join(rb.REF, "src_cpp"))
                              and shutil.which("g++") is not None)


needs_reference = pytest.mark.skipif(not rb.available(),
                                     reason="reference tree or C++ toolchain unavailable")


@needs_reference
def test_reference_binary_decodes():
    H = np.asarray(rep_code(9).todense(), np.uint8)
    e = np.zeros((2, 9), np.uint8)
    e[1, 4] = 1
    syn = (e @ H.T % 2).astype(np.uint8)
    secs, out = rb.run(rb.make_input(H, np.full(9, 0.05), syn), dump=True)
    assert secs >= 0 and np.array_equal(out, e)
