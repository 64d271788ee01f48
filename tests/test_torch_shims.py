"""The port's import-path shims, ldpc v1 classes and ``bp_decode_sim``,
held against the JAX package (tests/test_api_parity.py:14-50 and
tests/test_tooling.py:209-250, on ``device="cpu"``): every import path and
root name resolves, the callable-module trick keeps the v1 names callable,
and the v1 decoders and ``classical_decode_sim`` give JAX's outputs on the
same numpy-seeded inputs.
"""

import json

import numpy as np
import pytest

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.bp_decode_sim import classical_decode_sim as jax_decode_sim
from ldpc_tpu_torch.codes import rep_code, surface_code


def test_subpackage_import_paths():
    # reference: src_python/ldpc/bp_decoder/__init__.py:1-7
    from ldpc_tpu_torch.bp_decoder import (  # noqa: F401
        BpDecoder,
        BpDecoderBase,
        SoftInfoBpDecoder,
        bp_decoder,
        io_test,
    )
    # reference: src_python/ldpc/bposd_decoder/__init__.py:1-2
    from ldpc_tpu_torch.bposd_decoder import (  # noqa: F401
        BpOsdDecoder,
        SoftInfoBpOsdDecoder,
        bposd_decoder,
    )
    from ldpc_tpu_torch.bplsd_decoder import BpLsdDecoder  # noqa: F401
    from ldpc_tpu_torch.belief_find_decoder import BeliefFindDecoder  # noqa: F401
    from ldpc_tpu_torch.union_find_decoder import UnionFindDecoder  # noqa: F401
    from ldpc_tpu_torch.lsd_decoder import LsdDecoder  # noqa: F401
    from ldpc_tpu_torch.bp_flip import BpFlipDecoder  # noqa: F401
    from ldpc_tpu_torch.mbp_decoder import mbp_decoder  # noqa: F401
    from ldpc_tpu_torch.helpers.scipy_helpers import convert_to_binary_sparse
    from ldpc_tpu_torch.helpers import convert_to_binary_sparse as again

    assert convert_to_binary_sparse is again
    assert BpDecoder is ldpc_tpu_torch.BpDecoder
    assert bposd_decoder.__module__ == "ldpc_tpu_torch._legacy_v1"


ROOT_NAMES = ("BpDecoder", "BpOsdDecoder", "BpLsdDecoder", "SoftInfoBpDecoder",
              "BeliefFindDecoder", "SinterBpOsdDecoder", "UnionFindDecoder",
              "bp_decoder", "bposd_decoder")


@pytest.mark.parametrize("name", ROOT_NAMES)
def test_root_names(name):
    # reference root exports (src_python/ldpc/__init__.py:5-15)
    assert getattr(ldpc_tpu_torch, name) is not None
    assert getattr(ldpc_tpu, name) is not None
    assert name in ldpc_tpu_torch.__all__


@pytest.mark.parametrize("name", ["bp_decoder", "bposd_decoder"])
def test_callable_module(name):
    """After ``import ldpc_tpu_torch.<name>`` shadows the root's v1 class,
    calling the module still builds the v1 decoder."""
    import importlib

    from ldpc_tpu_torch import _legacy_v1

    module = importlib.import_module(f"ldpc_tpu_torch.{name}")
    assert getattr(ldpc_tpu_torch, name) is module
    H = np.asarray(rep_code(5).todense(), np.uint8)
    with pytest.warns(UserWarning, match="ldpc v1"):
        dec = module(H, error_rate=0.1, device="cpu")
    assert isinstance(dec, getattr(_legacy_v1, name))


def _v1_workload(seed=7):
    H = np.asarray(surface_code(3).hx.todense(), np.uint8)
    rng = np.random.default_rng(seed)
    errors = (rng.random((64, H.shape[1])) < 0.08).astype(np.uint8)
    return H, (errors @ H.T % 2).astype(np.uint8)


V1_CASES = {
    "bp_ps": ("bp_decoder", dict(error_rate=0.1, bp_method="ps")),
    "bp_ms_channel": ("bp_decoder", dict(channel_probs=list(np.full(13, 0.08)),
                                         bp_method="ms", ms_scaling_factor=0.625, max_iter=12)),
    "bposd_cs2": ("bposd_decoder", dict(error_rate=0.1, bp_method="ms", osd_method="osd_cs",
                                        osd_order=2)),
    "bposd_ps_osd0": ("bposd_decoder", dict(error_rate=0.08, max_iter=5)),
}


@pytest.mark.parametrize("case", list(V1_CASES))
def test_v1_decoders_match_jax(case):
    name, kw = V1_CASES[case]
    H, syn = _v1_workload()
    with pytest.warns(UserWarning, match="ldpc v1"):
        theirs = getattr(ldpc_tpu._legacy_v1, name)(H, **kw)
    with pytest.warns(UserWarning, match="ldpc v1"):
        ours = getattr(ldpc_tpu_torch, name)(H, device="cpu", **kw)
    np.testing.assert_array_equal(ours.decode_batch(syn), theirs.decode_batch(syn))
    for s in syn[:8]:
        x = ours.decode(s)
        np.testing.assert_array_equal(x, theirs.decode(s))
    np.testing.assert_array_equal(ours.channel_probs, theirs.channel_probs)
    ours.update_channel_probs(np.full(H.shape[1], 0.05))
    assert np.allclose(ours.channel_probs, 0.05)


def test_legacy_v1_decoders():
    """tests/test_tooling.py::test_legacy_v1_decoders on the port."""
    H = np.asarray(rep_code(8).todense(), np.uint8)
    with pytest.warns(UserWarning, match="ldpc v1"):
        dec = ldpc_tpu_torch.bp_decoder(H, error_rate=0.1, bp_method="ps", device="cpu")
    e = np.zeros(8, np.uint8)
    e[3] = 1
    s = H @ e % 2
    assert np.array_equal(H @ dec.decode(s) % 2, s)
    with pytest.warns(UserWarning, match="ldpc v1"):
        dec2 = ldpc_tpu_torch.bposd_decoder(
            H, error_rate=0.1, bp_method="ms", osd_method="osd_cs", osd_order=2, device="cpu")
    assert np.array_equal(H @ dec2.decode(s) % 2, s)
    with pytest.warns(UserWarning):
        dec3 = ldpc_tpu_torch.bp_decoder(H, channel_probs=list(np.full(8, 0.1)), device="cpu")
    assert np.allclose(dec3.channel_probs, 0.1)


def test_v1_argument_errors():
    H = np.asarray(rep_code(8).todense(), np.uint8)
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="eqaul"):
        ldpc_tpu_torch.bp_decoder(H, channel_probs=[0.1] * 3, device="cpu")
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="error_rate or channel_probs"):
        ldpc_tpu_torch.bposd_decoder(H, device="cpu")
    with pytest.warns(UserWarning), pytest.raises(Exception, match="input_vector"):
        ldpc_tpu_torch.bp_decoder(H, error_rate=0.1, input_vector_type="x", device="cpu")
    with pytest.warns(UserWarning):
        dec = ldpc_tpu_torch.bp_decoder(H, error_rate=0.1, input_vector_type=-1, device="cpu")
    assert dec.input_vector_type == "auto"


def test_v1_decoders_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    H = np.asarray(rep_code(5).todense(), np.uint8)
    for name in ("bp_decoder", "bposd_decoder"):
        with pytest.warns(UserWarning), pytest.raises(RuntimeError, match='pass device="cpu"'):
            getattr(ldpc_tpu_torch, name)(H, error_rate=0.1)


@pytest.mark.parametrize("bp_method,seed", [("ms", 3), ("ps", 5)])
def test_classical_decode_sim_matches_jax(tmp_path, bp_method, seed):
    """tests/test_tooling.py::test_classical_decode_sim_v1_shim's call on the
    port: the same numpy-seeded errors give JAX's counts; the JSON file."""
    from ldpc_tpu_torch.bp_decode_sim import classical_decode_sim

    kw = dict(target_runs=200, max_iter=10, seed=seed, bp_method=bp_method,
              ms_scaling_factor=1.0, output_dict={"code_type": "rep_code_50"})
    path = tmp_path / "out.json"
    out = classical_decode_sim(rep_code(50), 0.2, output_file=str(path), device="cpu", **kw)
    want = jax_decode_sim(rep_code(50), 0.2, **kw)
    assert out["run_count"] == 200
    assert 0 <= out["fail_count"] <= 200
    assert out["code_type"] == "rep_code_50"
    assert out["word_error_rate"] == out["fail_count"] / 200
    for key in ("run_count", "fail_count", "word_error_rate", "word_error_rate_eb", "seed"):
        assert out[key] == want[key], key
    assert json.loads(path.read_text())["fail_count"] == out["fail_count"]
    assert ldpc_tpu_torch.bp_decode_sim.classical_decode_sim is classical_decode_sim
