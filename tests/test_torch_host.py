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
from ldpc_tpu_torch.monte_carlo_simulation import (
    DeviceMonteCarlo,
    DeviceQss,
    QssSimulator,
    make_mc_decoder_step,
    make_qss_step,
    make_sharded_mc_step,
    make_sharded_qss_step,
)
from ldpc_tpu_torch.ops import flip as tflip
from ldpc_tpu_torch.ops import lsd as tlsd
from ldpc_tpu_torch.ops import mbp as tmbp
from ldpc_tpu_torch.ops import uf as tuf
from ldpc_tpu_torch.ops.pcm import compile_pcm as t_compile_pcm
from ldpc_tpu_torch import parallel as tpar
from ldpc_tpu_torch.bp_decode_sim import classical_decode_sim
from ldpc_tpu_torch.parallel import make_window_decoder
from ldpc_tpu_torch import ckt_noise as tckt
from ldpc_tpu_torch import sinter_decoders as tsinter
from ldpc_tpu_torch.ckt_noise import device_scan as tscan
from ldpc_tpu_torch.ckt_noise.not_an_arb_ckt_simulator import count_logical_errors
from test_ckt_noise import rep_code_memory_dem
from test_torch_ckt_noise import mock_circuit

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


def _mesh(d, axis="batch"):
    """The default mesh (every card), or two entries on ``d["device"]``."""
    if not d:
        return tpar.make_mesh(axis_name=axis)
    return tpar.make_mesh(devices=[d["device"]] * 2, axis_name=axis)


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
    "make_window_decoder": lambda d: make_window_decoder(_hx(), 4, 0.01, 0.01, **d),
    "make_qss_step": lambda d: make_qss_step(_hx(), 0.01, 0.01, _lx(), repetitions=4,
                                             rounds=8, batch_size=8, **d),
    "DeviceQss": lambda d: DeviceQss(_hx(), 0.01, 0.01, _lx(), repetitions=4, rounds=8,
                                     batch_size=8, **d),
    "QssSimulator": lambda d: QssSimulator(_hx().toarray(), 0.01, 0.01, _lx().toarray(),
                                           [1.0, 1.0, 1.0], repetitions=4, rounds=8, **d),
    "generate_bsc_error_batch": lambda d: tnoise.generate_bsc_error_batch(
        torch.Generator(), 4, 5, 0.1, **d),
    "generate_depolarizing_error_batch": lambda d: tnoise.generate_depolarizing_error_batch(
        torch.Generator(), 4, 5, 0.1, **d),
    "BpOsdOverlappingWindowDecoder": lambda d: tckt.BpOsdOverlappingWindowDecoder(
        rep_code_memory_dem(n_checks=3, rounds=14), **_OWD, **d),
    "LsdOverlappingWindowDecoder": lambda d: tckt.LsdOverlappingWindowDecoder(
        rep_code_memory_dem(n_checks=3, rounds=14), **_OWD, **d),
    "PyMatchingOverlappingWindowDecoder": lambda d: tckt.PyMatchingOverlappingWindowDecoder(
        rep_code_memory_dem(n_checks=3, rounds=14), **_OWD, **d),
    "make_device_owd": lambda d: tscan.make_device_owd(_uniform_windows(), 0.0, **d),
    "SinterBpOsdDecoder": lambda d: tsinter.SinterBpOsdDecoder(**d),
    "SinterLsdDecoder": lambda d: tsinter.SinterLsdDecoder(**d),
    "SinterBeliefFindDecoder": lambda d: tsinter.SinterBeliefFindDecoder(**d),
    "count_logical_errors": lambda d: count_logical_errors(mock_circuit(B=8), 8, **d),
    "bp_decoder": lambda d: ldpc_tpu_torch.bp_decoder(_hx(), error_rate=0.1, **d),
    "bposd_decoder": lambda d: ldpc_tpu_torch.bposd_decoder(_hx(), error_rate=0.1, **d),
    "classical_decode_sim": lambda d: classical_decode_sim(_hx(), 0.1, target_runs=8, **d),
    "make_mesh": lambda d: _mesh(d),
    "make_sharded_mc_step": lambda d: make_sharded_mc_step(
        _hx(), 0.05, mesh=_mesh(d) if d else None, batch_size_per_device=8),
    "make_sharded_qss_step": lambda d: make_sharded_qss_step(
        _hx(), 0.01, 0.01, _lx(), mesh=_mesh(d) if d else None, batch_size_per_device=8,
        repetitions=4, rounds=8),
    "make_rounds_sharded_window_decoder": lambda d: tpar.make_rounds_sharded_window_decoder(
        _hx(), 4, 0.01, 0.01, mesh=_mesh(d, "rounds"), n_windows=2),
    "make_pipelined_decoder": lambda d: tpar.make_pipelined_decoder(
        _hx(), 0.05, mesh=tpar.make_pipeline_mesh(devices=[d["device"]] * 2) if d else None),
    "TpBpDecoder": lambda d: tpar.TpBpDecoder(
        _hx(), tpar.Mesh([d.get("device", "cuda")] * 2, ("code",)), error_rate=0.05),
}
_OWD = dict(decodings=6, window=4, commit=2, num_checks=3)


def _uniform_windows():
    mats = tckt.detector_error_model_to_check_matrices(rep_code_memory_dem(n_checks=3, rounds=14))
    return tscan.analyze_uniform_windows(mats.check_matrix, 6, 4, 2, 3, mats.priors)


def _lx():
    return tcodes.surface_code(3, compute_logicals=True).lx


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


def test_ckt_noise_and_sinter_import_no_jax():
    """A fresh process decodes on the CPU through both overlapping-window
    decoders (device windows and host loop), the sinter adapters (packed
    path) and an overlapping-window sinter adapter, reaches
    ``ldpc_tpu_torch.SinterBpOsdDecoder`` lazily, drives every module of
    ``ldpc_tpu_torch.parallel`` (the mesh helpers, the rounds-sharded window
    decoder, the pipeline, tensor-parallel BP, the sharded MC and QSS steps,
    the single-process branch of the distributed layer), ``utils``, the
    three import shims (calling the shadowed v1 modules), ``_legacy_v1`` and
    ``bp_decode_sim``, and never imports jax or any module of the JAX
    package ``ldpc_tpu``."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, numpy as np\n"
        "import ldpc_tpu_torch\n"
        "assert 'ldpc_tpu_torch.sinter_decoders' not in sys.modules\n"
        "assert 'ldpc_tpu_torch.ckt_noise' not in sys.modules\n"
        "from ldpc_tpu_torch import ckt_noise\n"
        "from ldpc_tpu_torch.ckt_noise.sinter_overlapping_window_decoder import (\n"
        "    SinterDecoder_BPOSD_OWD)\n"
        "class T:\n"
        "    def __init__(self, kind, val=0): self.kind, self.val = kind, val\n"
        "    def is_relative_detector_id(self): return self.kind == 'det'\n"
        "    def is_logical_observable_id(self): return self.kind == 'obs'\n"
        "    def is_separator(self): return False\n"
        "class I:\n"
        "    type = 'error'\n"
        "    def __init__(self, p, t): self.p, self.t = p, t\n"
        "    def args_copy(self): return [self.p]\n"
        "    def targets_copy(self): return self.t\n"
        "class Dem:\n"
        "    num_detectors, num_observables = 42, 1\n"
        "    def flattened(self):\n"
        "        out = []\n"
        "        for r in range(14):\n"
        "            for j in range(4):\n"
        "                dets = [T('det', r * 3 + c) for c in (j - 1, j) if 0 <= c < 3]\n"
        "                out.append(I(0.02, dets + ([T('obs', 0)] if j == 0 else [])))\n"
        "            if r < 13:\n"
        "                out += [I(0.02, [T('det', r * 3 + c), T('det', r * 3 + 3 + c)])\n"
        "                        for c in range(3)]\n"
        "        return out\n"
        "dem = Dem()\n"
        "shots = np.zeros((4, 42), np.uint8)\n"
        "shots[1, [3, 6]] = 1\n"
        "kw = dict(decodings=6, window=4, commit=2, num_checks=3, device='cpu')\n"
        "for cls in (ckt_noise.BpOsdOverlappingWindowDecoder,\n"
        "            ckt_noise.LsdOverlappingWindowDecoder):\n"
        "    d = cls(dem, **kw)\n"
        "    assert d._maybe_device_scan() is not None\n"
        "    p = d.decode_batch(shots)\n"
        "    d._device_scan = None\n"
        "    assert (d.decode_batch(shots) == p).all() and p.shape == (4, 1)\n"
        "packed = np.packbits(shots, axis=1, bitorder='little')\n"
        "for name in ('SinterBpOsdDecoder', 'SinterLsdDecoder', 'SinterBeliefFindDecoder'):\n"
        "    a = getattr(ldpc_tpu_torch.sinter_decoders, name)(max_iter=10, device='cpu')\n"
        "    c = a.compile_decoder_for_dem(dem=dem)\n"
        "    assert c.decode_shots_bit_packed(bit_packed_detection_event_data=packed).shape == (4, 1)\n"
        "    assert a.decode_batch_from_dem(dem, shots).shape == (4, 1)\n"
        "assert ldpc_tpu_torch.SinterBpOsdDecoder is ldpc_tpu_torch.sinter_decoders.SinterBpOsdDecoder\n"
        "c = SinterDecoder_BPOSD_OWD(decodings=6, window=4, commit=2, num_checks=3,\n"
        "                            device='cpu').compile_decoder_for_dem(dem=dem)\n"
        "assert c.decode_shots_bit_packed(bit_packed_detection_event_data=packed).shape == (4, 1)\n"
        "import warnings\n"
        "warnings.simplefilter('ignore')\n"
        "import ldpc_tpu_torch.parallel as par\n"
        "from ldpc_tpu_torch.parallel import distributed, pipeline, sharding, tensor_parallel, window\n"
        "import ldpc_tpu_torch.bp_decoder, ldpc_tpu_torch.bposd_decoder, ldpc_tpu_torch.bplsd_decoder\n"
        "from ldpc_tpu_torch import _legacy_v1, bp_decode_sim, utils\n"
        "from ldpc_tpu_torch.utils import reference_baseline\n"
        "from ldpc_tpu_torch.codes import rep_code\n"
        "from ldpc_tpu_torch.monte_carlo_simulation import make_sharded_mc_step, make_sharded_qss_step\n"
        "H = rep_code(6)\n"
        "Hd = np.asarray(H.todense(), np.uint8)\n"
        "mesh = par.make_mesh(devices=['cpu'] * 2)\n"
        "x, B = par.shard_batch(np.arange(5)[:, None], mesh)\n"
        "assert int(par.psum_tally(x, mesh)) == 10 and par.unshard(x, B).shape == (5, 1)\n"
        "rounds = par.make_mesh(devices=['cpu'] * 2, axis_name='rounds')\n"
        "r = par.make_rounds_sharded_window_decoder(H, 4, 0.03, 0.02, mesh=rounds, n_windows=4,\n"
        "                                           microbatches=2)(np.zeros((4, 5, 10), np.uint8))\n"
        "assert not r.correction.any()\n"
        "syn = np.zeros((8, 5), np.uint8)\n"
        "syn[1] = Hd[:, 0]  # a weight-1 error's syndrome\n"
        "out = par.make_pipelined_decoder(H, 0.05, mesh=par.make_pipeline_mesh(devices=['cpu'] * 2),\n"
        "                                 microbatch_size=4)(syn)\n"
        "assert (out.astype(int) @ Hd.T % 2 == syn).all()\n"
        "tp = par.TpBpDecoder(H, par.Mesh(['cpu'] * 2, ('code',)), error_rate=0.05, max_iter=10)\n"
        "assert tp.decode_batch(syn).shape == (8, 6)\n"
        "step, runs = make_sharded_mc_step(H, 0.05, mesh=mesh, batch_size_per_device=8,\n"
        "                                  rounds_per_call=1, max_iter=4)\n"
        "import torch\n"
        "assert int(step(torch.Generator())[0]) == runs\n"
        "step, runs = make_sharded_qss_step(H, 0.02, 0.02, np.ones((1, 6), np.uint8), mesh=mesh,\n"
        "                                   batch_size_per_device=8, repetitions=4, rounds=8)\n"
        "assert int(step(torch.Generator())[0]) == runs\n"
        "assert par.initialize_distributed() == 0 and not par.is_distributed()\n"
        "t = utils.StageTimer()\n"
        "with t.stage('s'), utils.annotate('s'):\n"
        "    pass\n"
        "assert set(t.report()) == {'s'}\n"
        "for v1 in (ldpc_tpu_torch.bp_decoder, ldpc_tpu_torch.bposd_decoder):\n"
        "    assert (Hd @ v1(Hd, error_rate=0.1, device='cpu').decode(syn[1]) % 2 == syn[1]).all()\n"
        "assert isinstance(ldpc_tpu_torch.bp_decoder(Hd, error_rate=0.1, device='cpu'),\n"
        "                  _legacy_v1.bp_decoder)\n"
        "sim = bp_decode_sim.classical_decode_sim(H, 0.1, target_runs=16, max_iter=4, seed=1,\n"
        "                                         device='cpu')\n"
        "assert sim['run_count'] == 16\n"
        "assert reference_baseline.make_input(Hd, [0.1] * 6, syn[:1]).startswith('5 6')\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = sorted(m for m in sys.modules if m == 'ldpc_tpu' or m.startswith('ldpc_tpu.'))\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=repo, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
