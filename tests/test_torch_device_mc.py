"""The port's device Monte-Carlo (ldpc_tpu_torch.monte_carlo_simulation)
against the JAX package: exact counters on given errors, the logical error
rate within Monte-Carlo error of the JAX pipeline, exact resume, and the
two-phase cascade equal to a single-phase run."""

import numpy as np
import pytest
import torch

import jax

import ldpc_tpu
from ldpc_tpu.codes import rep_code, surface_code, toric_code
from ldpc_tpu.monte_carlo_simulation import make_mc_decoder_step as jax_mc_step
from ldpc_tpu_torch.monte_carlo_simulation import (
    DeviceMonteCarlo,
    make_mc_decoder_step,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("d,p,batch", [(5, 0.05, 512), (13, 0.01, 1024)])
def test_decode_round_matches_jax_decode_batch(d, p, batch):
    """Counters of one round on numpy errors equal the counters computed
    from the JAX decoder's decode_batch on the same errors."""
    code = surface_code(d, compute_logicals=True)
    H = np.asarray(code.hx.todense(), np.uint8)
    lx = np.asarray(code.lx.todense(), np.uint8)
    errors = (np.random.default_rng(7).random((batch, H.shape[1])) < p).astype(np.uint8)
    step, runs = make_mc_decoder_step(
        code.hx, p, logicals=code.lx, batch_size=batch, rounds_per_call=1,
        max_iter=30, ms_scaling_factor=0.625, bucket_fraction=2, device="cpu",
    )
    assert runs == batch
    got = step.decode_round(errors).numpy()

    dec = ldpc_tpu.BpOsdDecoder(
        code.hx, error_rate=p, max_iter=30, bp_method="minimum_sum",
        ms_scaling_factor=0.625, osd_method="osd_0",
    )
    out = dec.decode_batch((errors @ H.T % 2).astype(np.uint8))
    fails = (((errors ^ out) @ lx.T) % 2).any(axis=1)
    want = [
        batch,
        int(fails.sum()),
        int(dec.converge_batch.sum()),
        int(dec.iter_batch.sum()),
        int((~dec.converge_batch).sum()),
        0,
    ]
    assert got.tolist() == want
    assert want[4] > 0  # OSD-0 ran on some lanes


def test_ler_within_monte_carlo_error_of_jax():
    code = surface_code(5, compute_logicals=True)
    kw = dict(
        logicals=code.lx, batch_size=512, rounds_per_call=4, max_iter=20,
        ms_scaling_factor=0.625,
    )
    jstep, jruns = jax_mc_step(code.hx, 0.05, **kw)
    j = np.asarray(jstep(jax.random.key(3)))
    tstep, truns = make_mc_decoder_step(code.hx, 0.05, **kw, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    t = tstep(gen).numpy()
    assert j[0] == t[0] == jruns == truns == 2048
    pj, pt = j[1] / j[0], t[1] / t[0]
    pool = (j[1] + t[1]) / (j[0] + t[0])
    sigma = np.sqrt(pool * (1 - pool) * (1 / j[0] + 1 / t[0]))
    assert abs(pj - pt) <= 4 * sigma + 1e-3, (pj, pt, sigma)
    assert 0 < pt < 0.2
    # the BP statistics move together too
    assert abs(j[2] - t[2]) / j[0] < 0.03


def test_checkpoint_resume_is_exact():
    code = surface_code(3, compute_logicals=True)
    kwargs = dict(logicals=code.lx, batch_size=256, rounds_per_call=1, max_iter=8)
    mc1 = DeviceMonteCarlo(code.hx, 0.04, seed=7, **kwargs, device="cpu")
    mc1.run(512)
    state = mc1.checkpoint()
    res_a = mc1.run(1024)

    mc2 = DeviceMonteCarlo(code.hx, 0.04, seed=7, **kwargs, device="cpu")
    mc2.restore(state)
    res_b = mc2.run(1024)
    assert res_a == res_b
    assert res_a["run_count"] == 1024


def test_classical_word_error_counters_and_osd_off():
    step, runs = make_mc_decoder_step(
        rep_code(20), 0.05, batch_size=512, rounds_per_call=2, max_iter=10, device="cpu"
    )
    gen = torch.Generator()
    gen.manual_seed(0)
    out = step(gen).numpy()
    assert out[0] == runs == 1024
    assert 0 <= out[1] < 0.05 * out[0]
    assert 0 <= out[2] <= out[0]
    assert out[5] == 0
    off, runs_off = make_mc_decoder_step(
        rep_code(15), 0.05, batch_size=256, rounds_per_call=1, max_iter=10,
        osd_method="osd_off", device="cpu",
    )
    gen.manual_seed(1)
    assert off(gen).numpy()[0] == runs_off == 512  # padded to 512


@pytest.mark.parametrize(
    "builder,p,seed,phase1",
    [
        (lambda: surface_code(5, compute_logicals=True), 0.03, 11, 6),
        (lambda: surface_code(5, compute_logicals=True), 0.03, 11, 3),
        (lambda: toric_code(6, compute_logicals=True), 0.02, 3, 4),
        (lambda: toric_code(6, compute_logicals=True), 0.05, 7, 4),
    ],
)
def test_two_phase_matches_single_phase_counters(builder, p, seed, phase1):
    code = builder()
    kw = dict(
        logicals=code.lx, batch_size=512, rounds_per_call=2, max_iter=20,
        ms_scaling_factor=0.625, bucket_fraction=2,
    )
    single, _ = make_mc_decoder_step(code.hx, p, phase1_iters=20, **kw, device="cpu")
    two, _ = make_mc_decoder_step(code.hx, p, phase1_iters=phase1, **kw, device="cpu")
    ga, gb = torch.Generator(), torch.Generator()
    ga.manual_seed(seed)
    gb.manual_seed(seed)
    a = single(ga).tolist()
    b = two(gb).tolist()
    assert b[5] == 0, f"bucket overflow in test workload: {b}"
    assert a == b


def test_bucket_overflow_is_counted():
    """A bucket too small for the phase-1 failures reports the overflow."""
    code = surface_code(5, compute_logicals=True)
    step, _ = make_mc_decoder_step(
        code.hx, 0.08, logicals=code.lx, batch_size=512, rounds_per_call=1,
        max_iter=20, bucket_fraction=8, phase1_iters=1, device="cpu",
    )
    gen = torch.Generator()
    gen.manual_seed(5)
    out = step(gen).numpy()
    assert step.K == 128
    assert out[5] > 0
