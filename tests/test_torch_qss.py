"""The port's quasi-single-shot simulation (ldpc_tpu_torch.monte_carlo_
simulation: make_qss_step, DeviceQss, QssSimulator) against the JAX
package on the CPU.

torch's random stream is not jax.random's, so the device QSS is held two
ways:

- deterministically: QSS on given draws is the offline window decoder on
  the history those draws record. The draws are made with numpy; the port's
  ``QssStep.run`` simulates and decodes the shots on them, with binary and
  analog measurement noise. The recorded history is built from the same
  draws: the cumulative error with no commit applied, its noisy syndromes
  (in analog mode the noisy value QSS measured, whose hard bit is read
  back through the syndrome of the corrections committed before the round;
  those come from the JAX package's own window step on the history so
  far), and a perfect final round. JAX's ``make_window_decoder(...,
  use_pallas=False)`` decodes it, and each shot's logical failure and BP
  iterations must be those of the port's QSS;
- statistically: the logical error rates of the port's DeviceQss, the JAX
  package's DeviceQss and the port's host QssSimulator fall within each
  other's combined binomial error bars (4 sigma, or 0.02).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldpc_tpu.codes import rep_code, ring_code, surface_code
from ldpc_tpu.monte_carlo_simulation import DeviceQss as JaxDeviceQss
from ldpc_tpu.monte_carlo_simulation.simulation_utils import (
    error_channel_setup,
    get_sigma_from_syndr_er,
)
from ldpc_tpu.parallel import make_window_decoder as jax_window
from ldpc_tpu.parallel import window as jwindow
from ldpc_tpu_torch.monte_carlo_simulation import (
    BpParams,
    DeviceQss,
    QssSimulator,
    make_qss_step,
)

torch.set_num_threads(1)


def toric1d(n=8):
    """The ring code with the all-ones logical of tests/test_device_qss.py.
    Every residual with a zero syndrome has even weight there, so no shot
    ever fails: the codes whose shots can fail are rep7 and surface3."""
    H = np.asarray(ring_code(n).todense(), np.int32)
    L = np.ones((1, n), np.int32)
    return H, L


def rep7():
    return np.asarray(rep_code(7).todense(), np.int32), np.ones((1, 7), np.int32)


def _recorded_history(H, u, noise, per, ser, bias, W, R, analog, max_iter):
    """The offline view of a QSS run on the draws ``(u, noise)``: the
    recorded (B, m, R) syndrome history and analog values, the final
    cumulative error with no commit applied, and the JAX channels. The
    syndromes of the commits made before each round come from JAX's window
    step run on the history recorded so far."""
    m, n = H.shape
    T = W // 2
    B = u.shape[1]
    xb, yb, zb = error_channel_setup(per, bias, n)
    xs, ys, zs = error_channel_setup(ser, bias, m)
    data_channel, syndr_channel = yb + zb, zs + ys  # check side X
    sigma = get_sigma_from_syndr_er(syndr_channel[0]) if analog else None
    t0, t1, t2 = (np.float32(x) for x in (zb, zb + xb, zb + xb + yb))
    p_syn = syndr_channel.astype(np.float32)
    core = jwindow._build_core(H, W, data_channel, syndr_channel, max_iter=max_iter,
                               use_pallas=False, sigma=sigma)
    # jitted, as make_window_decoder's scan runs it (XLA folds 1 / sigma^2)
    window_step = jax.jit(lambda c, s, a: jwindow._window_step(core, c, s, False, a))
    carry = (jnp.zeros((B, m), jnp.uint8),) * 2 + (
        jnp.zeros((B, n), jnp.uint8), jnp.zeros(B, jnp.int32))
    hist = np.zeros((B, m, R), np.uint8)
    ana = np.zeros((B, m, R), np.float32)
    err = np.zeros((B, n), np.uint8)
    committed = np.zeros((B, m), np.uint8)  # H @ (commits so far)
    NW = R // T - 1
    for r in range(R):
        if r >= W and (r - W) % T == 0:  # a window decodes before round r
            w = (r - W) // T
            carry = window_step(
                carry, jnp.asarray(hist[:, :, w * T: w * T + W]),
                jnp.asarray(ana[:, :, w * T: w * T + W]) if analog else None)
            committed = np.asarray(carry[0])
        hit = (u[r] < t0) | ((u[r] >= t1) & (u[r] < t2))
        err ^= hit.astype(np.uint8)
        s = (err.astype(np.int64) @ H.T % 2).astype(np.uint8)
        final = r == R - 1
        if analog:
            measured = s ^ committed  # what the device shows after the commits
            a = (np.float32(1) - np.float32(2) * measured.astype(np.float32)) + (
                np.float32(0) if final else np.float32(sigma)) * noise[r]
            ana[:, :, r] = a
            hist[:, :, r] = (a < 0).astype(np.uint8) ^ committed
        else:
            hist[:, :, r] = s if final else s ^ (noise[r] < p_syn).astype(np.uint8)
    assert NW == (R - W) // T + 1
    return hist, (ana if analog else None), err, data_channel, syndr_channel, sigma


@pytest.mark.parametrize("analog", [False, True], ids=["binary", "analog"])
@pytest.mark.parametrize("code", ["rep7", "surface3"])
def test_qss_equals_offline_window_decoder_on_the_same_draws(code, analog):
    if code == "rep7":
        H, L = rep7()
        per, W, R, B = 0.08, 4, 10, 96
    else:
        c = surface_code(3, compute_logicals=True)
        H = np.asarray(c.hx.todense(), np.int32)
        L = np.asarray(c.lx.todense(), np.int32)
        per, W, R, B = 0.04, 4, 8, 96
    bias, max_iter = (1.0, 1.0, 1.0), 12
    rng = np.random.default_rng(17)
    m, n = H.shape
    u = rng.random((R, B, n), dtype=np.float32)
    noise = (rng.standard_normal((R, B, m), dtype=np.float32) if analog
             else rng.random((R, B, m), dtype=np.float32))
    step, _ = make_qss_step(H, per, per, L, repetitions=W, rounds=R, xyz_error_bias=bias,
                            analog_tg=analog, batch_size=B, max_iter=max_iter, device="cpu")
    shots = step.run(torch.from_numpy(u), torch.from_numpy(noise))

    hist, ana, err, pd, ps, sigma = _recorded_history(H, u, noise, per, per, bias, W, R,
                                                      analog, max_iter)
    want = jax_window(H, W, pd, ps, sigma=sigma, max_iter=max_iter, use_pallas=False)(
        hist, ana)
    residual = err ^ np.asarray(want.correction)
    want_fail = ((residual.astype(np.int64) @ L.T) % 2).any(axis=1)
    np.testing.assert_array_equal(shots.residual.numpy(), residual)
    np.testing.assert_array_equal(shots.logical_fail.numpy(), want_fail)
    np.testing.assert_array_equal(shots.bp_iterations.numpy(), np.asarray(want.bp_iterations))
    assert 0 < want_fail.sum() < B  # the draws exercise both outcomes


def _ler(out, side="z"):
    runs = out["nr_runs"]
    return (runs - out[f"{side}_success_cnt"]) / runs, runs


def _close(a, b):
    (pa, na), (pb, nb) = a, b
    eb = np.sqrt(pa * (1 - pa) / na + pb * (1 - pb) / nb)
    assert abs(pa - pb) <= max(4 * eb, 0.02), (pa, pb, eb)


@pytest.mark.parametrize("bias", [(1.0, 0.0, 0.0), (1.0, 1.0, 1.0)], ids=["x_bias", "depolarizing"])
def test_device_qss_ler_matches_jax_and_host_simulator(bias):
    """tests/test_device_qss.py:79's setting (ring code 6, per = ser =
    0.04, 4 repetitions, 8 rounds, 16 iterations) under its X-biased noise,
    which leaves the tracked Z side noiseless, and the same schedule on the
    repetition code under depolarizing noise at per = ser = 0.1, where
    shots fail."""
    H, L = rep7() if bias[1] else toric1d(6)
    per = ser = 0.1 if bias[1] else 0.04
    kw = dict(repetitions=4, rounds=8)
    host = QssSimulator(
        H=H, L=L, per=per, ser=ser, bias=list(bias), decoding_method="bposd", check_side="X",
        bp_params=BpParams(max_bp_iter=16, osd_method="osd_0", osd_order=0), seed=11,
        device="cpu", **kw,
    )
    host.eb_precission = 0.0  # disable early stopping
    host_out = host.run(samples=300)

    dev = DeviceQss(H, per, ser, L, seed=5, batch_size=512, max_iter=16,
                    xyz_error_bias=bias, device="cpu", **kw)
    dev_out = dev.run(samples=2048)
    jdev = JaxDeviceQss(H, per, ser, L, seed=5, batch_size=512, max_iter=16,
                        xyz_error_bias=bias, use_pallas=False, **kw)
    jax_out = jdev.run(samples=2048)
    assert dev_out["nr_runs"] == jax_out["nr_runs"] == 2048
    assert dev_out["windows_decoded"] == dev_out["nr_runs"] * 3
    _close(_ler(dev_out), _ler(jax_out))
    _close(_ler(dev_out), _ler(host_out))
    if bias[1]:
        assert _ler(dev_out)[0] > 0  # the depolarizing setting has failures


def test_qss_step_low_noise_no_failures():
    H, L = toric1d()
    step, runs = make_qss_step(H, 0.002, 0.002, L, repetitions=4, rounds=8, batch_size=64,
                               max_iter=12, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    out = step(gen).numpy()
    assert out[0] == runs == 64
    assert out[1] <= 1
    assert out[3] == 64 * 3


def test_qss_step_is_deterministic_and_analog_mode_runs():
    H, L = toric1d()
    for analog in (False, True):
        step, runs = make_qss_step(H, 0.05, 0.05, L, repetitions=4, rounds=8, batch_size=30,
                                   max_iter=8, analog_tg=analog, device="cpu")
        assert runs == 32  # rounded up to a multiple of 8
        outs = []
        for _ in range(2):
            gen = torch.Generator()
            gen.manual_seed(3)
            outs.append(step(gen).numpy())
        assert np.array_equal(*outs)
        assert outs[0][0] == runs and 0 <= outs[0][1] <= runs


def test_qss_step_rep_code_z_side():
    """check_side='Z' tracks X errors (rep code, X-biased noise)."""
    H = np.asarray(rep_code(7).todense(), np.int32)
    L = np.ones((1, 7), np.int32)
    step, runs = make_qss_step(H, 0.03, 0.03, L, repetitions=4, rounds=8, batch_size=64,
                               max_iter=8, check_side="Z", xyz_error_bias=(1.0, 0.0, 0.0),
                               device="cpu")
    gen = torch.Generator()
    gen.manual_seed(2)
    out = step(gen).numpy()
    assert out[0] == runs
    assert out[2] > 0  # X errors reach the decoder


def test_qss_validation_matches_jax():
    from ldpc_tpu.monte_carlo_simulation import make_qss_step as jax_step

    H, L = toric1d()
    for fn in (lambda **k: jax_step(H, 0.01, 0.01, L, use_pallas=False, **k),
               lambda **k: make_qss_step(H, 0.01, 0.01, L, device="cpu", **k)):
        with pytest.raises(ValueError, match="even"):
            fn(repetitions=3, rounds=6)
        with pytest.raises(ValueError, match="rounds"):
            fn(repetitions=4, rounds=7)
        with pytest.raises(ValueError, match="rounds"):
            fn(repetitions=4, rounds=2)
        with pytest.raises(ValueError, match="check_side"):
            fn(repetitions=4, rounds=8, check_side="Y")
    step, _ = make_qss_step(H, 0.01, 0.01, L, repetitions=4, rounds=8, batch_size=8,
                            device="cpu")
    with pytest.raises(ValueError, match="draws"):
        step.run(torch.zeros((8, 8, 8)), torch.zeros((7, 8, 8)))


def test_device_qss_checkpoint_resume():
    H, L = toric1d()
    kw = dict(seed=2, batch_size=64, repetitions=4, rounds=8, max_iter=8, device="cpu")
    a = DeviceQss(H, 0.03, 0.03, L, **kw)
    a.run(samples=128)
    state = a.checkpoint()
    a.run(samples=256)
    b = DeviceQss(H, 0.03, 0.03, L, **kw)
    b.restore(state)
    b.run(samples=256)
    assert np.array_equal(a.counters, b.counters)
    assert a.calls == b.calls == 4


@pytest.mark.parametrize("method", ["bposd", "lsd"])
def test_qss_simulator_matches_jax(method):
    """The port's host simulator draws from numpy's global RNG as the JAX
    package's does: same seed, same shots, same counts."""
    from ldpc_tpu.monte_carlo_simulation import QssSimulator as JaxQss

    H, L = toric1d(6)
    kw = dict(H=H, L=L, per=0.03, ser=0.03, bias=[1.0, 1.0, 1.0], decoding_method=method,
              check_side="X", rounds=6, repetitions=4, seed=7,
              bp_params=BpParams(max_bp_iter=12, osd_method="osd_0", osd_order=0))
    want = JaxQss(**kw).run(samples=40)
    got = QssSimulator(device="cpu", **kw).run(samples=40)
    assert got == want
    with pytest.raises(ValueError, match="even"):
        QssSimulator(**{**kw, "repetitions": 3}, device="cpu")
    with pytest.raises(ValueError, match="Decoding method"):
        QssSimulator(**{**kw, "decoding_method": "bogus"}, device="cpu")
