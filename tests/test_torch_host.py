"""The port's own host modules against the JAX package's: the PCM compiler
(``ops/pcm.py``), the code constructions (``codes/``), input validation
(``helpers.py``) and the host GF(2) rank and kernel (``mod2``); and the
port's device rule: every public entry point runs on the CUDA device unless
the caller passes ``device="cpu"``, and without a card the default raises."""

import numpy as np
import pytest
import scipy.sparse
import torch

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu import codes as jcodes
from ldpc_tpu.helpers import convert_to_binary_sparse as j_convert
from ldpc_tpu.ops.pcm import compile_pcm as j_compile_pcm
from ldpc_tpu_torch import codes as tcodes
from ldpc_tpu_torch import mod2 as tmod2
from ldpc_tpu_torch import noise_models as tnoise
from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse as t_convert
from ldpc_tpu_torch.monte_carlo_simulation import DeviceMonteCarlo, make_mc_decoder_step
from ldpc_tpu_torch.ops import flip as tflip
from ldpc_tpu_torch.ops import lsd as tlsd
from ldpc_tpu_torch.ops import mbp as tmbp
from ldpc_tpu_torch.ops import uf as tuf
from ldpc_tpu_torch.ops.pcm import compile_pcm as t_compile_pcm

GROSS = (12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])

PCMS = {
    "hamming3": lambda c: c.hamming_code(3),
    "rep5": lambda c: c.rep_code(5),
    "ring7": lambda c: c.ring_code(7),
    "surface5": lambda c: c.surface_code(5, compute_logicals=False).hx,
    "surface13": lambda c: c.surface_code(13, compute_logicals=False).hx,
    "toric20": lambda c: c.toric_code(20, compute_logicals=False).hx,
}


@pytest.mark.parametrize("name", list(PCMS))
def test_compile_pcm_matches_jax(name):
    """Field by field, same values and dtypes."""
    want = j_compile_pcm(PCMS[name](jcodes))
    got = t_compile_pcm(PCMS[name](tcodes))
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field
    assert got.num_edges == want.num_edges


CSS = {
    "surface3": lambda c: c.surface_code(3),
    "surface5": lambda c: c.surface_code(5),
    "toric4": lambda c: c.toric_code(4),
    "hgp_ring3_ring4": lambda c: c.hgp(c.ring_code(3), c.ring_code(4)),
    "hgp_code_rep3_hamming3": lambda c: c.hgp_code(c.rep_code(3), c.hamming_code(3)),
    "gross_144_12_12": lambda c: c.bivariate_bicycle_code(*GROSS),
}


def _dense(m):
    return np.asarray(m.todense(), np.uint8)


@pytest.mark.parametrize("name", list(CSS))
def test_css_codes_match_jax(name):
    want = CSS[name](jcodes)
    got = CSS[name](tcodes)
    for field in ("hx", "hz", "lx", "lz"):
        np.testing.assert_array_equal(_dense(getattr(got, field)), _dense(getattr(want, field)),
                                      err_msg=field)
    assert (got.n, got.k, got.name) == (want.n, want.k, want.name)
    assert got.validate()
    if name == "gross_144_12_12":
        assert (got.n, got.k) == (144, 12)


@pytest.mark.parametrize(
    "make",
    [lambda c: c.rep_code(6), lambda c: c.ring_code(5), lambda c: c.hamming_code(4),
     lambda c: c.random_binary_code(20, 40, 5, seed=3, variance=1.0)],
    ids=["rep6", "ring5", "hamming4", "random"],
)
def test_classical_codes_match_jax(make):
    np.testing.assert_array_equal(_dense(make(tcodes)), _dense(make(jcodes)))


def test_code_exports_match_jax():
    assert tcodes.__all__ == jcodes.__all__
    assert ldpc_tpu_torch.codes.surface_code is tcodes.surface_code


BAD_INPUTS = {
    "list": [[1, 0], [0, 1]],
    "bool_array": np.eye(3, dtype=bool),
    "float32_array": np.eye(3, dtype=np.float32),
    "non_binary_int": np.array([[1, 2], [0, 1]]),
    "non_binary_float": np.array([[1.0, 0.5], [0.0, 1.0]]),
    "non_binary_sparse": scipy.sparse.csr_matrix(np.array([[1, 3], [0, 1]], np.uint8)),
}


@pytest.mark.parametrize("name", list(BAD_INPUTS))
def test_convert_to_binary_sparse_raises_like_jax(name):
    with pytest.raises((TypeError, ValueError)) as want:
        j_convert(BAD_INPUTS[name])
    with pytest.raises(want.type) as got:
        t_convert(BAD_INPUTS[name])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "matrix",
    [np.array([[1, 0, 1], [0, 1, 1]], np.uint8), np.array([[1, 0], [0, 1]], np.int64),
     np.array([[1.0, 0.0]]), scipy.sparse.csc_matrix(np.array([[0, 1], [1, 0]], np.int32))],
    ids=["uint8", "int64", "float", "csc_int32"],
)
def test_convert_to_binary_sparse_matches_jax(matrix):
    want, got = j_convert(matrix), t_convert(matrix)
    assert got.format == want.format == "csr" and got.dtype == want.dtype
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    assert got.nnz == want.nnz


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mod2_matches_jax(seed):
    """rank, kernel and pivot rows on random rank-deficient matrices."""
    rng = np.random.default_rng(seed)
    a = (rng.random((12, 30)) < 0.3).astype(np.uint8)
    m = np.vstack([a, a[:4] ^ a[4:8]])  # 4 dependent rows
    assert tmod2.rank(m) == ldpc_tpu.mod2.rank(m)
    np.testing.assert_array_equal(tmod2.nullspace(m).toarray(), ldpc_tpu.mod2.nullspace(m).toarray())
    np.testing.assert_array_equal(tmod2.pivot_rows(m), ldpc_tpu.mod2.pivot_rows(m))
    with pytest.raises(TypeError):
        tmod2.rank(m.tolist())


# ---- the device rule -------------------------------------------------------------


def _graph():
    return t_compile_pcm(tcodes.surface_code(3, compute_logicals=False).hx)


def _hx():
    return tcodes.surface_code(3, compute_logicals=False).hx


ENTRY_POINTS = {
    "BpDecoder": lambda d: ldpc_tpu_torch.BpDecoder(_hx(), error_rate=0.1, **d),
    "BpOsdDecoder": lambda d: ldpc_tpu_torch.BpOsdDecoder(_hx(), error_rate=0.1, **d),
    "BpLsdDecoder": lambda d: ldpc_tpu_torch.BpLsdDecoder(_hx(), error_rate=0.1, **d),
    "BeliefFindDecoder": lambda d: ldpc_tpu_torch.BeliefFindDecoder(_hx(), error_rate=0.1, **d),
    "LsdDecoder": lambda d: ldpc_tpu_torch.LsdDecoder(_hx(), **d),
    "UnionFindDecoder": lambda d: ldpc_tpu_torch.UnionFindDecoder(_hx(), **d),
    "FlipDecoder": lambda d: ldpc_tpu_torch.FlipDecoder(_hx(), **d),
    "BpFlipDecoder": lambda d: ldpc_tpu_torch.BpFlipDecoder(_hx(), error_rate=0.1, **d),
    "make_uf_decoder": lambda d: tuf.make_uf_decoder(_graph(), **d),
    "make_peel_decoder": lambda d: tuf.make_peel_decoder(_graph(), **d),
    "make_lsd_decoder": lambda d: tlsd.make_lsd_decoder(_graph(), **d),
    "make_flip_decoder": lambda d: tflip.make_flip_decoder(_graph(), 4, 0, **d),
    "make_mc_decoder_step": lambda d: make_mc_decoder_step(_hx(), 0.05, batch_size=512, **d),
    "DeviceMonteCarlo": lambda d: DeviceMonteCarlo(_hx(), 0.05, batch_size=512, **d),
    "MbpDecoder": lambda d: ldpc_tpu_torch.MbpDecoder(
        HX_CSS=_hx(), HZ_CSS=tcodes.surface_code(3, compute_logicals=False).hz,
        error_rate=0.1, **d),
    "make_mbp_decoder": lambda d: _make_mbp(d),
    "generate_bsc_error_batch": lambda d: tnoise.generate_bsc_error_batch(
        torch.Generator(), 4, 5, 0.1, **d),
    "generate_depolarizing_error_batch": lambda d: tnoise.generate_depolarizing_error_batch(
        torch.Generator(), 4, 5, 0.1, **d),
}


def _make_mbp(d):
    h = _hx().toarray().astype(np.uint8)
    return tmbp.make_mbp_decoder(tmbp.compile_gf4(h), np.full((3, h.shape[1]), 0.03), 5,
                                 np.ones((3, h.shape[1])), 0.0, tmbp.PRODUCT_SUM, 1.0, **d)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_raises_without_a_card(monkeypatch, name):
    """Without a card the default device raises and says to pass
    ``device="cpu"``, rather than running on the CPU unasked; with
    ``device="cpu"`` the same call builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[name]({})
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        ENTRY_POINTS[name]({"device": "cuda:0"})
    assert ENTRY_POINTS[name]({"device": "cpu"}) is not None


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
