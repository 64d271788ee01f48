"""The port's device Monte-Carlo (ldpc_tpu_torch.monte_carlo_simulation)
against the JAX package: exact counters on given errors, the logical error
rate within Monte-Carlo error of the JAX pipeline, exact resume, and the
two-phase cascade equal to a single-phase run; on the CPU the step runs
eagerly, with the counters it always had.

On a CUDA device (``cuda``) the step replays a captured round: its
decodings and counters against the eager round's on the same errors, its
capture and replay counters, its launches against the eager round's, and
an earlier call's decodings left alone by a later call. The codes are the
port's (equal to the JAX package's) and JAX is imported only by the tests
that run it, so the card's tests run without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_device_mc.py -q
"""

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import rep_code, surface_code, toric_code
from ldpc_tpu_torch.monte_carlo_simulation import (
    DeviceMonteCarlo,
    make_mc_decoder_step,
)
from ldpc_tpu_torch.monte_carlo_simulation.device_mc import call_seed
from ldpc_tpu_torch.utils import profiling as pf

torch.set_num_threads(1)


@pytest.mark.parametrize("d,p,batch", [(5, 0.05, 512), (13, 0.01, 1024)])
def test_decode_round_matches_jax_decode_batch(d, p, batch):
    """Counters of one round on numpy errors equal the counters computed
    from the JAX decoder's decode_batch on the same errors."""
    import ldpc_tpu

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
    import jax

    from ldpc_tpu.monte_carlo_simulation import make_mc_decoder_step as jax_mc_step

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


# The counters of these CPU calls as the step gave them before its count of
# runs was filled on the device (it was a host-to-device copy, which a CUDA
# graph cannot hold): surface d=5 at p = 0.05, 512 shots x 2 rounds, seeds
# 2**31 + 25 and 7
EAGER_COUNTERS = {
    "bucket_holds": (2, None, [[1024, 32, 738, 6860, 286, 0], [1024, 31, 760, 6441, 264, 0]]),
    "bucket_overflows": (8, 1, [[1024, 78, 553, 3557, 471, 347], [1024, 68, 588, 3500, 436, 315]]),
}


@pytest.mark.parametrize("case", sorted(EAGER_COUNTERS))
def test_the_cpu_step_runs_eagerly_with_its_counters(case):
    """On the CPU a call captures nothing (no ``mc.graph.*`` counter) and
    its counters are those the step always gave."""
    bucket_fraction, phase1, want = EAGER_COUNTERS[case]
    code = surface_code(5, compute_logicals=True)
    step, _ = make_mc_decoder_step(
        code.hx, 0.05, logicals=code.lx, batch_size=512, rounds_per_call=2, max_iter=20,
        bucket_fraction=bucket_fraction, phase1_iters=phase1, device="cpu")
    got = []
    pf.drain()
    pf.record(True)
    try:
        for seed in (2**31 + 25, 7):
            gen = torch.Generator()
            gen.manual_seed(seed)
            got.append(step(gen).tolist())
    finally:
        pf.record(False)
    counters = pf.drain().counters
    assert got == want
    assert step._graph is None
    assert not any(k.startswith("mc.graph") for k in counters), counters
    assert counters["mc.rounds"] == 4


# ---------------------------------------------------------------------------
# On a card: surface d=13 at p = 0.01, 4,096 shots x 3 rounds a call


CARD_ROUNDS = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _recorded(fn):
    """``fn()`` with the recorder on: its value and the counters."""
    pf.drain()
    pf.record(True)
    try:
        out = fn()
    finally:
        pf.record(False)
    return out, pf.drain().counters


def _launches(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k.startswith("launch.")}


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_fraction,phase1", [(8, None), (32, 2)],
                         ids=["bucket_holds", "bucket_overflows"])
def test_graph_rounds_equal_eager_rounds_on_the_card(card, bucket_fraction, phase1):
    """Three calls at each of two seeds: every round's decodings and the
    call's counters equal the eager ``_round``'s on the same errors; the
    step captures once and replays a round at a time; a call counts the
    eager rounds' launches (the capturing call one round more, its eager
    warm-up); an earlier call's decodings outlive a later call."""
    code = surface_code(13, compute_logicals=True)
    step, runs = make_mc_decoder_step(
        code.hx, 0.01, logicals=code.lx, batch_size=4096, rounds_per_call=CARD_ROUNDS,
        max_iter=30, ms_scaling_factor=0.625, bucket_fraction=bucket_fraction,
        phase1_iters=phase1, device=card)
    assert runs == 4096 * CARD_ROUNDS
    calls, captures, replays, overflow = 0, 0, 0, 0
    for seed in (2**31 + 25, 11):
        kept = None
        for call in range(3):
            gen = torch.Generator(device=card)
            gen.manual_seed(call_seed(seed, call))
            got, counters = _recorded(lambda: step(gen).cpu())
            captures += counters.get("mc.graph.captures", 0)
            replays += counters["mc.graph.replays"]
            assert counters["mc.graph.replays"] == CARD_ROUNDS
            if kept is not None:  # the last call's decodings, as they were
                previous, snapshot = kept
                assert all(torch.equal(a, b) for a, b in zip(previous, snapshot))
            decodings = step.last_decodings
            kept = decodings, [d.clone() for d in decodings]

            eager_gen = torch.Generator(device=card)
            eager_gen.manual_seed(call_seed(seed, call))
            want = torch.zeros(6, dtype=torch.int64)
            eager_launches = {}
            for decoding in decodings:
                errors = step.sample_errors(eager_gen)
                (c, x), eager = _recorded(lambda: step._round(errors))
                assert torch.equal(decoding, x)
                want += c.cpu()
                for k, v in _launches(eager).items():
                    eager_launches[k] = eager_launches.get(k, 0) + v
            assert torch.equal(step._errors, errors)
            assert got.tolist() == want.tolist()
            overflow += int(got[5])
            per_round = {k: v // CARD_ROUNDS for k, v in eager_launches.items()}
            assert per_round["launch.bp_parallel"] == 2 and per_round["launch.osd0"] == 1
            extra = 1 if counters.get("mc.graph.captures") else 0
            assert _launches(counters) == {
                k: v * (CARD_ROUNDS + extra) for k, v in per_round.items()}
            calls += 1
    assert captures == 1 and replays == CARD_ROUNDS * calls
    assert (overflow > 0) == (bucket_fraction == 32)


@pytest.mark.cuda
def test_decode_round_stays_eager_on_the_card(card):
    """``decode_round`` takes errors of any batch and runs them eagerly: no
    capture, the counters of the graph's round on the same errors."""
    code = surface_code(13, compute_logicals=True)
    step, _ = make_mc_decoder_step(
        code.hx, 0.01, logicals=code.lx, batch_size=1024, rounds_per_call=1, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    errors = step.sample_errors(gen)
    odd, counters = _recorded(lambda: step.decode_round(errors[:700]).cpu())
    assert odd[0] == 700 and step._graph is None
    assert not any(k.startswith("mc.graph") for k in counters)
    gen.manual_seed(5)
    replayed = step(gen).cpu()
    assert step._graph is not None
    assert replayed.tolist() == step.decode_round(errors).cpu().tolist()
