"""The port's host memory-experiment modules (ldpc_tpu_torch.monte_carlo_
simulation: memory_experiment, simulation_utils, data_utils, mcs) against
the JAX package's. They are copies, so wherever the inputs are shared the
outputs are equal exactly; functions that draw from numpy's global RNG are
seeded alike on both sides. decode_multiround and MonteCarloBscSimulation
run the port's decoders on ``device="cpu"`` beside the JAX package's."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpc_tpu
from ldpc_tpu.codes import hamming_code, rep_code, ring_code, surface_code
from ldpc_tpu.monte_carlo_simulation import data_utils as jdu
from ldpc_tpu.monte_carlo_simulation import memory_experiment as jme
from ldpc_tpu.monte_carlo_simulation import simulation_utils as jsu
from ldpc_tpu.monte_carlo_simulation import MonteCarloBscSimulation as JMcs
import ldpc_tpu_torch
from ldpc_tpu_torch.monte_carlo_simulation import data_utils as tdu
from ldpc_tpu_torch.monte_carlo_simulation import memory_experiment as tme
from ldpc_tpu_torch.monte_carlo_simulation import simulation_utils as tsu
from ldpc_tpu_torch.monte_carlo_simulation import MonteCarloBscSimulation as TMcs

torch.set_num_threads(1)

PCMS = {
    "rep5": lambda: rep_code(5),
    "ring6": lambda: ring_code(6),
    "surface3": lambda: surface_code(3).hx,
    "hamming3": lambda: hamming_code(3),
}


def _same_sparse(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    assert (a != b).nnz == 0
    assert a.dtype == b.dtype


@pytest.mark.parametrize("reps", [1, 3, 5])
@pytest.mark.parametrize("name", list(PCMS))
def test_build_multiround_pcm_matches_jax(name, reps):
    H = PCMS[name]()
    _same_sparse(tme.build_multiround_pcm(H, reps), jme.build_multiround_pcm(H, reps))
    dense = np.asarray(H.todense()) if hasattr(H, "todense") else H
    _same_sparse(tme.build_multiround_pcm(dense, reps), jme.build_multiround_pcm(dense, reps))


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_move_syndrome_matches_jax(dtype):
    s = np.random.default_rng(3).integers(0, 2, (7, 6)).astype(dtype)
    want = jme.move_syndrome(s, data_type=dtype)
    got = tme.move_syndrome(s, data_type=dtype)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _bposd(lib, H3D, channel, **extra):
    return lib.BpOsdDecoder(
        H3D.tocsr(), error_channel=list(channel), max_iter=16, bp_method="minimum_sum",
        osd_method="osd_0", osd_order=0, ms_scaling_factor=0.625, **extra,
    )


def _bplsd(lib, H3D, channel, **extra):
    return lib.BpLsdDecoder(
        H3D.tocsr(), error_channel=list(channel), max_iter=16, bp_method="ms",
        ms_scaling_factor=0.625, lsd_order=0, **extra,
    )


@pytest.mark.parametrize("method", ["bposd", "lsd"])
@pytest.mark.parametrize("mode", ["binary", "analog", "last_round", "analog_last_round"])
def test_decode_multiround_matches_jax(mode, method):
    """One window step, through each side's own decoder, on the same noisy
    syndrome window: the commit, the propagated syndrome and the BP
    iterations are equal."""
    H = np.asarray(ring_code(6).todense(), np.int32)
    m, n = H.shape
    reps = 4
    H3D = jme.build_multiround_pcm(H, reps - 1)
    block = n * reps
    channel = np.concatenate([np.full(block, 0.03), np.full(m * reps, 0.02)])
    analog = mode.startswith("analog")
    last = mode.endswith("last_round")
    sigma = jsu.get_sigma_from_syndr_er(0.02)
    make = _bposd if method == "bposd" else _bplsd
    rng = np.random.default_rng(11)
    for trial in range(3):
        err = np.zeros(n, np.int32)
        syn = np.zeros((m, reps), np.int32)
        ana = np.zeros((m, reps)) if analog else None
        for r in range(reps):
            err ^= (rng.random(n) < 0.08).astype(np.int32)
            s = (H @ err) % 2
            if analog:
                ana[:, r] = (1 - 2 * s) + sigma * rng.standard_normal(m)
                syn[:, r] = ana[:, r] < 0
            else:
                syn[:, r] = s ^ (rng.random(m) < 0.05)
        outs = []
        for lib, me, extra in ((ldpc_tpu, jme, {}), (ldpc_tpu_torch, tme, {"device": "cpu"})):
            dec = make(lib, H3D, channel, **extra)
            outs.append(me.decode_multiround(
                syn.copy(), H, dec, channel, reps, last_round=last,
                analog_syndr=None if ana is None else ana.copy(),
                check_block_size=block, sigma=sigma, decoding_method=method,
            ))
        (dj, sj, aj, ij), (dt, st, at, it) = outs
        assert np.array_equal(dt, dj), trial
        assert dt.dtype == dj.dtype
        assert np.array_equal(st, sj), trial
        assert it == ij
        if analog:
            assert np.array_equal(at, aj)


def test_get_updated_decoder_matches_jax():
    H3D = jme.build_multiround_pcm(rep_code(4), 1)
    channel = np.full(H3D.shape[1], 0.05)
    dec = tme.get_updated_decoder("bposd", _bposd(ldpc_tpu_torch, H3D, channel, device="cpu"),
                                  np.full(H3D.shape[1], 0.1))
    assert np.allclose(dec.channel_probs, 0.1)
    for me in (jme, tme):
        with pytest.raises(ValueError, match="Unknown decoding method"):
            me.get_updated_decoder("bogus", None, channel)


@pytest.mark.parametrize("bias", [(1.0, 1.0, 1.0), (1.0, 0.0, 0.0), (np.inf, 1, 1),
                                  (1, np.inf, 1), (1, 1, np.inf), (0.5, 2.0, 1.0)])
def test_error_channel_setup_matches_jax(bias):
    for got, want in zip(tsu.error_channel_setup(0.03, bias, 7),
                         jsu.error_channel_setup(0.03, bias, 7)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("ser", [1e-4, 0.003, 0.01, 0.05, 0.2])
def test_sigma_conversions_match_jax(ser):
    sigma = tsu.get_sigma_from_syndr_er(ser)
    assert sigma == jsu.get_sigma_from_syndr_er(ser)
    assert tsu.get_error_rate_from_sigma(sigma) == jsu.get_error_rate_from_sigma(sigma)
    y = np.random.default_rng(1).standard_normal(20) * 2
    assert np.array_equal(tsu.get_analog_llr(y, sigma), jsu.get_analog_llr(y, sigma))
    assert np.array_equal(tsu.get_virtual_check_init_vals(y, sigma),
                          jsu.get_virtual_check_init_vals(y, sigma))


@pytest.mark.parametrize("seed", [0, 5])
def test_sampling_matches_jax_on_the_same_global_seed(seed):
    """generate_err, generate_syndr_err and get_noisy_analog_syndrome draw
    from numpy's global RNG: seeded alike, both sides give the same draws."""
    rng = np.random.default_rng(seed)
    N = 40
    chans = [rng.random(N) * 0.2 for _ in range(3)]
    resid = [rng.integers(0, 2, N), rng.integers(0, 2, N)]
    perfect = rng.integers(0, 2, N)
    outs = []
    for su in (jsu, tsu):
        su.set_seed(seed)
        outs.append((
            *su.generate_err(N, chans, [r.copy() for r in resid]),
            su.generate_syndr_err(chans[0]),
            su.get_noisy_analog_syndrome(perfect, 0.3),
        ))
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_logical_checks_and_pcm_helpers_match_jax():
    code = surface_code(3, compute_logicals=True)
    H = np.asarray(code.hx.todense(), np.uint8)
    L = code.lx
    rng = np.random.default_rng(2)
    for _ in range(20):
        e, d = rng.integers(0, 2, (2, H.shape[1]))
        assert tsu.check_logical_err_h(H, e, d) == jsu.check_logical_err_h(H, e, d)
        assert tsu.is_logical_err(L, e ^ d) == jsu.is_logical_err(L, e ^ d)
    M = rng.integers(0, 2, (3, H.shape[0]))
    assert np.array_equal(tsu.build_single_stage_pcm(H, M), jsu.build_single_stage_pcm(H, M))
    s = rng.integers(0, 2, 9)
    assert np.array_equal(tsu.get_signed_from_binary(s), jsu.get_signed_from_binary(s))
    a = rng.standard_normal(9)
    assert np.array_equal(tsu.get_binary_from_analog(a), jsu.get_binary_from_analog(a))


def test_save_results_matches_jax(tmp_path):
    params = dict(success_cnt=90, nr_runs=100, p=0.01, s=0.02,
                  input_vals={"bias": [1.0, np.inf, 0.5], "code": "x"},
                  code_params={"n": 13, "k": 1}, err_side="z", bp_iterations=350,
                  bp_params=jdu.BpParams())
    want = jsu.save_results(outfile=str(tmp_path / "j.json"), **params)
    got = tsu.save_results(outfile=str(tmp_path / "t.json"), **{
        **params, "bp_params": tdu.BpParams()})
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    assert {k: v for k, v in got.items() if k != "bp_params"} == {
        k: v for k, v in want.items() if k != "bp_params"}


@pytest.mark.parametrize("success,runs,k", [(0, 10, 1), (9, 10, 1), (990, 1000, 2),
                                            (1000, 1000, 3)])
def test_error_rates_and_convergence_match_jax(success, runs, k):
    cp = {"k": k, "n": 10}
    assert tdu.calculate_error_rates(success, runs, cp) == jdu.calculate_error_rates(
        success, runs, cp)
    for prec in (1e-1, 1e-3):
        assert tdu.is_converged(success, success, runs, cp, prec) == jdu.is_converged(
            success, success, runs, cp, prec)


def test_config_helpers_match_jax():
    d = {"bp_method": "ms", "max_bp_iter": 7, "unknown": 1}
    assert tdu.BpParams.from_dict(d).__dict__ == jdu.BpParams.from_dict(d).__dict__
    assert tdu.replace_inf([1, np.inf, 2.0]) == jdu.replace_inf([1, np.inf, 2.0])
    kw = dict(a=[1, 2], b=["x", "y"])
    assert list(tdu.product_dict(**kw)) == list(jdu.product_dict(**kw))
    assert list(tdu.zip_dict(**kw)) == list(jdu.zip_dict(**kw))


def _write_runs(root):
    """A per-worker results tree: root/<code>/<setting>/id_*.json."""
    rng = np.random.default_rng(4)
    for setting in ("per_0.01", "per_0.02"):
        folder = root / "code" / setting
        folder.mkdir(parents=True)
        for i in range(3):
            rec = {"code_K": 2, "nr_runs": int(rng.integers(50, 100)), "pers": setting}
            if i != 1:
                rec["x_success_cnt"] = int(rng.integers(40, 50))
            if i != 2:
                rec["z_success_cnt"] = int(rng.integers(40, 50))
            (folder / f"id_{i}.json").write_text(json.dumps(rec))
        (folder / "broken.json").write_text("{not json")


@pytest.mark.parametrize("merge", ["merge_json_files", "merge_json_files_x",
                                   "merge_json_files_z", "merge_json_files_xz"])
def test_merge_json_files_match_jax(tmp_path, merge):
    outs = []
    for name, du in (("j", jdu), ("t", tdu)):
        root = tmp_path / name
        _write_runs(root)
        getattr(du, merge)(str(root / "code"))
        outs.append(json.loads((root / "code.json").read_text()))
    assert outs[0] == outs[1] and outs[0]


def test_settings_load_and_outpath_match_jax(tmp_path):
    lines = [{"a": 1, "b": "x"}, {"a": 2, "b": "x"}, {"a": 1, "c": [1, 2]}]
    f = tmp_path / "params.jsonl"
    f.write_text("\n".join(json.dumps(x) for x in lines) + "\n\n")
    assert tdu.extract_settings(str(f)) == jdu.extract_settings(str(f))
    for name, du in (("j", jdu), ("t", tdu)):
        _write_runs(tmp_path / name)
    jdu.merge_json_files(str(tmp_path / "j" / "code"))
    # the port's load_data merges the per-worker directory of a missing file
    got = tdu.load_data([str(tmp_path / "t" / "code.json")])
    want = jdu.load_data([str(tmp_path / "j" / "code.json")])
    assert got == want
    kw = dict(bias=[1, 0, 0], codename="c", rounds=4, repetitions=2, data_err_rate=0.01,
              syndr_err_rate=0.02, analog_tg=True)
    paths = [du.create_outpath(results_root=str(tmp_path / name / "res"), **kw)
             for name, du in (("j", jdu), ("t", tdu))]
    assert os.path.relpath(paths[0], tmp_path / "j") == os.path.relpath(paths[1], tmp_path / "t")
    again = tdu.create_outpath(results_root=str(tmp_path / "t" / "res"), **kw)
    assert again.endswith("id_1.json")


@pytest.mark.parametrize("name", ["hamming3", "surface3"])
def test_monte_carlo_bsc_simulation_matches_jax(name):
    """Same seed, same batches of errors: the port's simulation with the
    port's BpOsdDecoder counts what the JAX package's counts with its own,
    and a checkpoint resumes exactly."""
    H = PCMS[name]()
    H = sp.csr_matrix(H)
    kw = dict(error_rate=0.08, target_run_count=300, tqdm_disable=True, seed=9, batch_size=128)
    dec = dict(error_rate=0.08, max_iter=10, bp_method="ms", osd_method="osd_0")
    want = JMcs(H, Decoder=ldpc_tpu.BpOsdDecoder(H, **dec), **kw).run()
    tdec = ldpc_tpu_torch.BpOsdDecoder(H, device="cpu", **dec)
    got = TMcs(H, Decoder=tdec, **kw).run()
    assert got == want and got["fail_count"] > 0
    part = TMcs(H, Decoder=tdec, **{**kw, "target_run_count": 128})
    part.run()
    state = part.checkpoint()
    resumed = TMcs(H, Decoder=tdec, **kw)
    resumed.restore(state)
    assert resumed.run() == got


def test_monte_carlo_bsc_simulation_validation_matches_jax():
    H = np.asarray(hamming_code(3).todense())
    for bad in (dict(parity_check_matrix=[[1]]), dict(error_rate=2.0), dict(Decoder=None),
                dict(target_run_count=0), dict(seed=1.5)):
        kw = dict(parity_check_matrix=H, error_rate=0.1, Decoder=object()) | bad
        for cls in (JMcs, TMcs):
            with pytest.raises(ValueError):
                cls(**kw)
