"""The port's sliding-window decoder (ldpc_tpu_torch.parallel.window) and
K1''s per-lane prior, held against the JAX package on the CPU.

- K1''s plain version with a (B, n) prior against the JAX package's fast
  engine fed the same prior: decisions, flags and iterations exact;
  min-sum posteriors within 1e-6 and product-sum posteriors within the
  tolerances of tests/test_torch_ops.py (the fp ties and tanh ulps stated
  there). An (n,) prior and the same prior broadcast to (B, n) give
  identical outputs.
- ``_build_core``: the space-time PCM, the four priors and the analog
  window priors equal the JAX package's bit for bit.
- ``make_window_decoder`` against the JAX package's (``use_pallas=False``)
  on the cases of tests/test_device_window.py: ``correction`` and
  ``bp_iterations`` equal on every lane, binary, analog and LSD-0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldpc_tpu.codes import rep_code, surface_code, toric_code
from ldpc_tpu.monte_carlo_simulation import build_multiround_pcm as jax_multiround
from ldpc_tpu.monte_carlo_simulation.simulation_utils import get_sigma_from_syndr_er
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu.parallel import make_window_decoder as jax_window
from ldpc_tpu.parallel import window as jwindow
from ldpc_tpu_torch.monte_carlo_simulation import build_multiround_pcm
from ldpc_tpu_torch.ops import bp as tbp
from ldpc_tpu_torch.ops import bp_cuda
from ldpc_tpu_torch.ops.pcm import graph_to_torch
from ldpc_tpu_torch.parallel import WindowDecodeResult, make_window_decoder
from ldpc_tpu_torch.parallel import window as twindow
from test_device_window import gen_history

torch.set_num_threads(1)


def _per_lane_workload(name, B=64, seed=7):
    """(graph, syndromes, (B, n) prior): the multiround PCM of surface d=3
    takes the analog window's prior (channel LLRs on the space block,
    |2 a / sigma^2| on the time block), the others random priors."""
    rng = np.random.default_rng(seed)
    if name == "surface3_w4":
        H, W = surface_code(3).hx, 4
        graph = compile_pcm(jax_multiround(H, W - 1))
        sigma = get_sigma_from_syndr_er(0.03)
        n_space = H.shape[1] * W
        a = (1 - 2 * (rng.random((B, graph.n - n_space)) < 0.1)) + sigma * rng.standard_normal(
            (B, graph.n - n_space))
        time = np.abs(2.0 * a.astype(np.float32) / np.float32(sigma) ** 2)
        space = np.broadcast_to(jbp.channel_llr(np.full(n_space, 0.03)), (B, n_space))
        prior = np.concatenate([space, time], axis=1).astype(np.float32)
        p = 0.03
    else:
        H, p = {"surface5": (surface_code(5).hx, 0.05), "toric20": (toric_code(20).hx, 0.03)}[name]
        graph = compile_pcm(H)
        prior = (0.5 + 5.5 * rng.random((B, graph.n))).astype(np.float32)
    errors = (rng.random((B, graph.n)) < p).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    return graph, syn, prior


METHODS = {"ms0.625": (tbp.MINIMUM_SUM, 0.625), "ms_dynamic": (tbp.MINIMUM_SUM, 0.0),
           "product_sum": (tbp.PRODUCT_SUM, 1.0)}


def _both(graph, syn, prior, method, alpha, max_iter):
    rj = jbp.make_parallel_decoder(graph, method, max_iter, alpha, jnp.float32)(
        jnp.asarray(syn), jnp.asarray(prior))
    rt = tbp.make_parallel_decoder(graph, method, max_iter, alpha, "cpu")(
        torch.from_numpy(syn), torch.from_numpy(prior))
    return rj, rt


@pytest.mark.parametrize("config", list(METHODS))
@pytest.mark.parametrize("name", ["surface5", "toric20", "surface3_w4"])
def test_per_lane_prior_matches_jax(name, config):
    graph, syn, prior = _per_lane_workload(name)
    method, alpha = METHODS[config]
    rj, rt = _both(graph, syn, prior, method, alpha, 30)
    assert (rt.converged.numpy() == np.asarray(rj.converged)).all()
    assert (rt.iterations.numpy() == np.asarray(rj.iterations)).all()
    assert (rt.decoding.numpy() == np.asarray(rj.decoding)).all()
    lj, lt = np.asarray(rj.llr_posterior), rt.llr_posterior.numpy()
    if method == tbp.MINIMUM_SUM:
        np.testing.assert_allclose(lt, lj, rtol=1e-6, atol=1e-6)
    elif name != "toric20":
        np.testing.assert_allclose(lt, lj, rtol=1e-3, atol=1e-3)
    else:
        # saturated product-sum lanes of a large code drift by the tanh
        # ulps (tests/test_torch_ops.py); one iteration is held to 1e-5
        rj1, rt1 = _both(graph, syn, prior, method, alpha, 1)
        np.testing.assert_allclose(rt1.llr_posterior.numpy(), np.asarray(rj1.llr_posterior),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", list(METHODS))
def test_shared_prior_equals_its_broadcast(config):
    """One (n,) prior and the same prior as a (B, n) tensor: identical
    outputs, posteriors included, through the decoder and the bare plain
    version."""
    graph, syn, _ = _per_lane_workload("surface5", B=48)
    method, alpha = METHODS[config]
    prior = torch.from_numpy(tbp.channel_llr(np.full(graph.n, 0.05)))
    s = torch.from_numpy(syn)
    dec = tbp.make_parallel_decoder(graph, method, 20, alpha, "cpu")
    one = dec(s, prior)
    lanes = dec(s, prior.expand(48, graph.n))
    bare = bp_cuda.bp_parallel_reference(graph_to_torch(graph, "cpu"), s,
                                         prior.expand(48, graph.n).contiguous(),
                                         method, 20, alpha)
    for x, y, z in zip(one, lanes, bare):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_per_lane_prior_shapes_are_checked():
    graph, syn, prior = _per_lane_workload("surface5", B=8)
    tg = graph_to_torch(graph, "cpu")
    s, p = torch.from_numpy(syn), torch.from_numpy(prior)
    with pytest.raises(ValueError, match="CUDA"):
        bp_cuda.bp_parallel_cuda(tg, s, p, tbp.MINIMUM_SUM, 5, 0.625)
    f64 = tbp.make_parallel_decoder(graph, tbp.MINIMUM_SUM, 5, 0.625, "cpu", dtype="float64")
    with pytest.raises(ValueError, match=r"\(n,\) prior only"):
        f64(s, p.double())
    f64(s, p[0].double())  # an (n,) prior runs


CORE_CASES = {
    "rep6": (lambda: rep_code(6), 4, 0.04, 0.03, None),
    "surface3": (lambda: surface_code(3).hx, 4, 0.02, 0.02, None),
    "surface3_analog": (lambda: surface_code(3).hx, 6, 0.02, 0.01, 0.4),
    "rep10_per_bit": (lambda: rep_code(10), 4, np.linspace(0.01, 0.05, 10),
                      np.linspace(0.02, 0.04, 9), 0.5),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_build_core_matches_jax(case):
    make, W, pd, ps, sigma = CORE_CASES[case]
    H = make()
    jc = jwindow._build_core(H, W, pd, ps, use_pallas=False, sigma=sigma)
    tc = twindow._build_core(H, W, pd, ps, sigma=sigma, device="cpu")
    assert (tc.m, tc.n, tc.W, tc.T, tc.n_space) == (jc.m, jc.n, jc.W, jc.T, jc.n_space)
    for f in ("Ht_f32", "llr_mid", "llr_last", "llr_space"):
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert tc.llr_time_last.dtype == torch.float32
    assert tc.llr_time_last.item() == float(jc.llr_time_last)
    a = jax_multiround(H, W - 1)
    b = build_multiround_pcm(H, W - 1)
    assert (a != b).nnz == 0
    if sigma is None:
        return
    # the analog windows' (B, n3d) priors: JAX's _window_step, jitted, with
    # its decode replaced by a probe that keeps the prior
    B = 5
    rng = np.random.default_rng(3)
    a_win = (rng.standard_normal((B, tc.m, W)) * 1.3).astype(np.float32)
    for is_last in (False, True):
        seen = {}

        def probe(syn, init_llr):
            seen["llr"] = init_llr
            return jnp.zeros((B, init_llr.shape[1]), jnp.uint8), jnp.zeros(B, jnp.int32)

        core = jc._replace(window_decode=probe)
        carry = (jnp.zeros((B, jc.m), jnp.uint8),) * 2 + (
            jnp.zeros((B, jc.n), jnp.uint8), jnp.zeros(B, jnp.int32))
        step = jax.jit(
            lambda c, s, a: (jwindow._window_step(core, c, s, is_last, a), seen["llr"]))
        want = np.asarray(step(carry, jnp.zeros((B, jc.m, W), jnp.uint8), jnp.asarray(a_win))[1])
        got = twindow._window_prior(tc, is_last, torch.from_numpy(a_win)).numpy()
        assert got.shape == want.shape == (B, jc.n_space + jc.m * W)
        assert np.array_equal(got, want), is_last


def _analog_history(H, R, B, sigma, p, seed=5):
    """tests/test_device_window.py's analog history: signed syndromes plus
    N(0, sigma) noise, the final round perfect."""
    Hd = np.asarray(H.todense())
    m, n = Hd.shape
    rng = np.random.default_rng(seed)
    syn = np.zeros((B, m, R), np.uint8)
    analog = np.zeros((B, m, R))
    err = np.zeros((B, n), np.uint8)
    for t in range(R):
        err ^= (rng.random((B, n)) < p).astype(np.uint8)
        s = (err @ Hd.T) % 2
        if t < R - 1:
            noisy = (1.0 - 2.0 * s) + rng.normal(0, sigma, s.shape)
            analog[:, :, t] = noisy
            syn[:, :, t] = (noisy < 0).astype(np.uint8)
        else:
            analog[:, :, t] = 1.0 - 2.0 * s
            syn[:, :, t] = s
    return syn, analog


# name: (pcm, W, R, B, p_data, p_meas, history seed, decoder keywords)
WINDOW_CASES = {
    "rep6": (lambda: rep_code(6), 4, 10, 12, 0.04, 0.03, 11, {"max_iter": 20}),
    "surface3": (lambda: surface_code(3).hx, 4, 8, 8, 0.02, 0.02, 7, {"max_iter": 20}),
    "surface5_R10": (lambda: surface_code(5).hx, 4, 10, 48, 0.01, 0.01, 3, {"max_iter": 20}),
    "rep12_lsd0": (lambda: rep_code(12), 6, 15, 32, 0.004, 0.003, 5, {"postprocess": "lsd0"}),
    "surface5_lsd0": (lambda: surface_code(5).hx, 4, 10, 8, 0.01, 0.01, 7,
                      {"postprocess": "lsd0"}),
    "surface3_product_sum": (lambda: surface_code(3).hx, 4, 8, 16, 0.03, 0.02, 9,
                             {"bp_method": "product_sum", "max_iter": 12}),
    "rep8_no_osd": (lambda: rep_code(8), 4, 12, 16, 0.05, 0.03, 2, {"osd": False}),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_decoder_matches_jax(case):
    make, W, R, B, pd, pm, seed, kw = WINDOW_CASES[case]
    H = make()
    syn, _ = gen_history(H, R, pd, pm, B, seed=seed)
    want = jax_window(H, W, pd, pm, use_pallas=False, **kw)(syn)
    got = make_window_decoder(H, W, pd, pm, device="cpu", **kw)(syn)
    assert isinstance(got, WindowDecodeResult)
    assert got.correction.dtype == torch.uint8 and got.bp_iterations.dtype == torch.int32
    np.testing.assert_array_equal(got.correction.numpy(), np.asarray(want.correction))
    np.testing.assert_array_equal(got.bp_iterations.numpy(), np.asarray(want.bp_iterations))
    assert int(got.bp_iterations.sum()) > 0


@pytest.mark.parametrize("postprocess", ["osd0", "lsd0"])
@pytest.mark.parametrize("case", ["rep10", "surface3"])
def test_window_decoder_analog_matches_jax(case, postprocess):
    """Analog mode (tests/test_device_window.py:186): per-shot time-like
    priors from float32 analog values, through K1''s per-lane prior."""
    H, W, sigma, p = {"rep10": (rep_code(10), 4, 0.4, 0.01),
                      "surface3": (surface_code(3).hx, 4, 0.5, 0.02)}[case]
    syn, analog = _analog_history(H, 10, 24, sigma, p)
    kw = dict(sigma=sigma, postprocess=postprocess)
    want = jax_window(H, W, p, 0.05, use_pallas=False, **kw)(syn, analog)
    got = make_window_decoder(H, W, p, 0.05, device="cpu", **kw)(syn, analog)
    np.testing.assert_array_equal(got.correction.numpy(), np.asarray(want.correction))
    np.testing.assert_array_equal(got.bp_iterations.numpy(), np.asarray(want.bp_iterations))
    Hd = np.asarray(H.todense())
    assert got.correction.numpy().any()
    assert Hd.shape[1] == got.correction.shape[1]


def test_window_decoder_zero_syndromes():
    H = rep_code(5)
    syn = np.zeros((3, H.shape[0], 8), np.uint8)
    got = make_window_decoder(H, 4, 0.05, 0.02, device="cpu")(syn)
    want = jax_window(H, 4, 0.05, 0.02, use_pallas=False)(syn)
    assert not got.correction.any()
    np.testing.assert_array_equal(got.bp_iterations.numpy(), np.asarray(want.bp_iterations))


def test_window_decoder_validation_matches_jax():
    H = rep_code(5)
    for fn in (lambda **k: jax_window(H, use_pallas=False, **k),
               lambda **k: make_window_decoder(H, device="cpu", **k)):
        with pytest.raises(ValueError, match="even"):
            fn(repetitions=3, data_channel=0.01, syndr_channel=0.01)
        with pytest.raises(ValueError, match="postprocess"):
            fn(repetitions=4, data_channel=0.01, syndr_channel=0.01, postprocess="bogus")
        dec = fn(repetitions=4, data_channel=0.01, syndr_channel=0.01)
        with pytest.raises(ValueError, match="tile"):
            dec(np.zeros((2, 4, 7), np.uint8))
        with pytest.raises(ValueError, match="tile"):
            dec(np.zeros((2, 4, 2), np.uint8))
        with pytest.raises(ValueError, match="rows"):
            dec(np.zeros((2, 3, 8), np.uint8))
    dec = make_window_decoder(H, 4, 0.01, 0.01, device="cpu")
    with pytest.raises(ValueError, match="sigma"):
        dec(np.zeros((2, 4, 8), np.uint8), np.zeros((2, 4, 8)))
    dec = make_window_decoder(H, 4, 0.01, 0.01, sigma=0.5, device="cpu")
    with pytest.raises(ValueError, match="analog shape"):
        dec(np.zeros((2, 4, 8), np.uint8), np.zeros((2, 4, 6)))
