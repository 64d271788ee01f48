"""The port's sliding-window decoder (``make_window_decoder``) against the
benchmark's plain reference (``benchmark/reference/window.py``) on the
CPU, lane for lane:

- the reference's space-time matrix is ``build_multiround_pcm``'s, column
  order included;
- its min-sum on a prior a lane equals ``reference/bp.py``'s run lane by
  lane, each lane on its own (n,) prior;
- its sigma and analog scale are the port's (``get_sigma_from_syndr_er``,
  ``_build_core``'s ``analog_scale``);
- on d=5 surface-code histories of 8 and 12 rounds, binary and analog,
  the total corrections equal bit for bit and the summed iterations
  equal, and some windows leave lanes to OSD-0.

It imports no JAX."""

import functools

import numpy as np
import pytest
import torch

from benchmark.reference import bp, codes
from benchmark.reference import window as ref
from ldpc_tpu_torch.monte_carlo_simulation import build_multiround_pcm
from ldpc_tpu_torch.monte_carlo_simulation.simulation_utils import get_sigma_from_syndr_er
from ldpc_tpu_torch.parallel import make_window_decoder
from ldpc_tpu_torch.parallel import window as twindow

torch.set_num_threads(1)

D, P, B, W = 5, 0.03, 64, 4
KW = dict(max_iter=30, alpha=0.625)


def _hx(d=D):
    return codes.build({"family": "surface", "distance": d})


@functools.cache
def _history(rounds: int, seed: int = 5):
    """(syndromes (B, m, rounds) uint8, analog values (B, m, rounds)
    float32): a data flip at P a bit and round, analog readout at the sigma
    of P, the last round perfect."""
    H = _hx()
    m, n = H.shape
    rng = np.random.default_rng(seed)
    sigma = ref.sigma_from_rate(P)
    err = np.zeros((B, n), np.uint8)
    syn = np.zeros((B, m, rounds), np.uint8)
    ana = np.zeros((B, m, rounds), np.float32)
    for r in range(rounds):
        err ^= (rng.random((B, n)) < P).astype(np.uint8)
        s = (err @ H.T % 2).astype(np.uint8)
        noise = 0.0 if r == rounds - 1 else sigma * rng.standard_normal((B, m))
        ana[:, :, r] = (1.0 - 2.0 * s) + noise
        syn[:, :, r] = ana[:, :, r] < 0
    return syn, ana


@pytest.mark.parametrize("d,window", [(3, 2), (5, 4), (13, 4), (5, 6)])
def test_space_time_matrix_is_build_multiround_pcms(d, window):
    H = _hx(d)
    want = build_multiround_pcm(H, window - 1).toarray()
    got = ref.space_time(H, window)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    if (d, window) == (13, 4):
        assert got.shape == (624, 1876) and int(got.sum()) == 3492


def test_lane_prior_min_sum_is_bp_lane_by_lane():
    """A (B, n) prior, a row a lane (channel LLRs beside random analog
    ones), against ``reference/bp.py`` on each lane with its own row."""
    A = ref.space_time(_hx(3), 4)
    g = bp.graph(A, "cpu")
    rng = np.random.default_rng(11)
    lanes = 48
    err = (rng.random((lanes, A.shape[1])) < 0.08).astype(np.uint8)
    syn = torch.from_numpy((err @ A.T % 2).astype(np.uint8))
    prior = np.abs(rng.standard_normal((lanes, A.shape[1])) * 4.0).astype(np.float32)
    got = ref.min_sum(g, syn, torch.from_numpy(prior), **KW)
    for b in range(lanes):
        want = bp.min_sum(g, syn[b : b + 1], torch.from_numpy(prior[b]), **KW)
        for field in ("decoding", "posterior", "converged", "iterations"):
            assert torch.equal(getattr(got, field)[b], getattr(want, field)[0]), (b, field)
    assert not bool(got.converged.all()) and bool(got.converged.any())


def test_sigma_and_analog_scale_are_the_ports():
    sigma = ref.sigma_from_rate(0.003)
    assert sigma == get_sigma_from_syndr_er(0.003)
    core = twindow._build_core(_hx(), W, P, P, sigma=sigma, device="cpu")
    assert core.analog_scale.item() == float(ref.analog_scale(sigma))
    assert core.analog_scale.dtype == torch.float32


@functools.cache
def _decoded(rounds: int, analog: bool):
    syn, ana = _history(rounds)
    sigma = ref.sigma_from_rate(P) if analog else None
    H = _hx()
    port = make_window_decoder(H, W, P, P, sigma=sigma, max_iter=KW["max_iter"],
                               ms_scaling_factor=KW["alpha"], device="cpu")
    got = port(syn, ana if analog else None)
    dec = ref.Decoder(H, rounds, W, P, P, sigma, KW["max_iter"], KW["alpha"], "cpu")
    want = dec.decode(torch.from_numpy(syn), torch.from_numpy(ana) if analog else None)
    return got, want


@pytest.mark.parametrize("analog", [False, True], ids=["binary", "analog"])
@pytest.mark.parametrize("rounds", [8, 12])
def test_corrections_and_iterations_are_the_references(rounds, analog):
    got, (x, iterations, work) = _decoded(rounds, analog)
    assert got.correction.dtype == torch.uint8 and got.correction.shape == x.shape
    assert torch.equal(got.correction, x)
    assert torch.equal(got.bp_iterations.to(torch.int64), iterations)
    assert len(work) == (rounds - W) // (W // 2) + 1
    assert all(w["bp_lanes"] == B for w in work)
    assert sum(w["osd_lanes"] for w in work) > 0
    assert int(iterations.sum()) == sum(w["bp_lane_iterations"] for w in work)


def test_analog_and_binary_decode_differently():
    """The analog priors change the decoding of some shots: the mode is
    not a no-op in either program or reference."""
    (_, (x_bin, it_bin, _)), (_, (x_ana, it_ana, _)) = _decoded(12, False), _decoded(12, True)
    assert not (torch.equal(x_bin, x_ana) and torch.equal(it_bin, it_ana))
