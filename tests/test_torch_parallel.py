"""The port's multi-device surface (``ldpc_tpu_torch.parallel`` and the
sharded Monte-Carlo and QSS steps), held against the JAX package on the
CPU. The port's meshes name the CPU more than once (``["cpu"] * D``), as
JAX's run on the 8 virtual CPU devices of tests/conftest.py.

- ``shard_batch``, ``unshard``, ``psum_tally`` at 1, 2 and 8 entries:
  equal to JAX's, padding included.
- ``make_rounds_sharded_window_decoder`` at D = 1, 2 and 4 on the cases of
  tests/test_device_window.py: corrections and iterations equal, bit for
  bit, to JAX's rounds-sharded decoder and to the port's
  ``make_window_decoder``.
- ``make_pipelined_decoder`` on tests/test_pipeline.py's workload (surface
  d=5, 600 syndromes at p=0.08, microbatch 128, <= 12 iterations;
  ``(stage, batch)``, stage-only and BP-only meshes): every row equal to
  JAX's pipeline and to the unpipelined composition.
- ``make_tp_bp_decoder`` in min-sum and product-sum, on 1-D and 2-D meshes
  and with uneven checks, under tests/test_tensor_parallel.py's rule:
  flags and iterations equal, decisions equal on converged lanes,
  posteriors within rtol = atol = 2e-4 (of JAX's TP decoder and of K1''s
  plain version).
- ``make_sharded_mc_step`` / ``make_sharded_qss_step``: counters exactly
  the sum of the per-entry local steps on the entries' generators, and the
  1-vs-8-entry logical error rates (and, for QSS, runs and windows
  decoded) within 5 binomial sigmas of JAX's 8-device step.

Their card twins (a two-entry mesh of one card against the CPU path) are in
tests/test_torch_kernels.py, which imports no jax.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from ldpc_tpu.codes import hamming_code, rep_code, surface_code
from ldpc_tpu.monte_carlo_simulation import make_sharded_mc_step as jax_sharded_mc
from ldpc_tpu.monte_carlo_simulation import make_sharded_qss_step as jax_sharded_qss
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu.parallel import make_mesh as jax_make_mesh
from ldpc_tpu.parallel import make_pipeline_mesh as jax_pipeline_mesh
from ldpc_tpu.parallel import make_pipelined_decoder as jax_pipelined
from ldpc_tpu.parallel import make_rounds_sharded_window_decoder as jax_rounds
from ldpc_tpu.parallel import make_tp_bp_decoder as jax_tp
from ldpc_tpu.parallel import psum_tally as jax_psum_tally
from ldpc_tpu.parallel import shard_batch as jax_shard_batch
from ldpc_tpu.parallel import unshard as jax_unshard
import ldpc_tpu.parallel as jax_parallel
import ldpc_tpu_torch.parallel as parallel
from ldpc_tpu_torch.monte_carlo_simulation import (
    make_mc_decoder_step,
    make_qss_step,
    make_sharded_mc_step,
    make_sharded_qss_step,
)
from ldpc_tpu_torch.ops import bp as tbp
from ldpc_tpu_torch.parallel import (
    Mesh,
    TpBpDecoder,
    make_mesh,
    make_pipeline_mesh,
    make_pipelined_decoder,
    make_rounds_sharded_window_decoder,
    make_tp_bp_decoder,
    make_window_decoder,
    psum_tally,
    shard_batch,
    unshard,
)
from test_device_window import gen_history
from test_pipeline import _reference_decode

torch.set_num_threads(1)


def cpu_mesh(D, axis="batch"):
    return make_mesh(devices=["cpu"] * D, axis_name=axis)


def test_exports_match_the_jax_package():
    assert set(jax_parallel.__all__) <= set(parallel.__all__)
    for name in jax_parallel.__all__:
        assert getattr(parallel, name) is not None


# ---- sharding helpers -----------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("B", [16, 13])
def test_shard_unshard_psum_tally_match_jax(D, B):
    """Padding to a multiple of the mesh, the shards, the round trip and
    the summed tallies equal JAX's on an 8-device CPU mesh."""
    rng = np.random.default_rng(D * 100 + B)
    x = rng.integers(0, 5, (B, 3)).astype(np.int32)
    jm = jax_make_mesh(D)
    jsh, jB = jax_shard_batch(x, jm)
    tsh, tB = shard_batch(x, cpu_mesh(D))
    assert jB == tB == B
    assert len(tsh.shards) == D
    assert {tuple(s.shape) for s in tsh.shards} == {(-(-B // D), 3)}
    np.testing.assert_array_equal(np.asarray(tsh), np.asarray(jsh))
    np.testing.assert_array_equal(unshard(tsh, B), jax_unshard(jsh, jB))
    np.testing.assert_array_equal(unshard(tsh, B), x)
    assert int(psum_tally(tsh, cpu_mesh(D))) == int(jax_psum_tally(jsh, jm)) == int(x.sum())


def test_replicate_and_mesh_surface():
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("batch", "code"))
    assert mesh.shape == {"batch": 2, "code": 2} and mesh.size == 4
    assert mesh.axis_devices("code") == [torch.device("cpu")] * 2
    rep = parallel.replicate(np.arange(5.0), mesh)
    assert len(rep.shards) == 4
    np.testing.assert_array_equal(np.asarray(rep), np.arange(5.0))
    with mesh:  # the JAX code's ``with mesh:`` reads the same
        pass
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("batch", "code"))


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_mesh, make_pipeline_mesh, lambda: make_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match='pass device="cpu"'):
            build()


def test_run_entries_gives_each_card_a_thread(monkeypatch):
    """Entries on two distinct cards run in a thread a card, each card's
    entries in entry order, results in entry order; entries of one device
    (or the CPU) run on the calling thread. The cards are stand-ins: the
    device guard is a no-op here."""
    import contextlib
    import threading

    from ldpc_tpu_torch.parallel.sharding import run_entries

    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    seen = []

    def fn(i):
        seen.append((i, threading.current_thread()))  # ids are reused, threads not
        return 10 * i

    cards = [torch.device("cuda", k) for k in (0, 1, 0, 1)] + [torch.device("cpu")]
    assert run_entries(cards, fn) == [0, 10, 20, 30, 40]
    thread = dict(seen)
    assert thread[0] is thread[2] and thread[1] is thread[3]
    assert thread[0] is not thread[1]
    assert thread[4] is threading.current_thread()
    order = [i for i, _ in seen]
    assert order.index(0) < order.index(2) and order.index(1) < order.index(3)
    seen.clear()
    assert run_entries([torch.device("cuda", 0)] * 2 + [torch.device("cpu")], fn) == [0, 10, 20]
    assert all(t is threading.current_thread() for _, t in seen)


# ---- the rounds-sharded window decoder ---------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4])
def test_rounds_sharded_matches_jax_and_the_window_decoder(D):
    """tests/test_device_window.py::test_rounds_sharded_equivalence's case:
    rep code 6, windows of 4, 8 windows, 4 microbatches, <= 16 iterations."""
    H = rep_code(6)
    W, B, NW = 4, 8, 8
    R = (NW + 1) * (W // 2)
    syn, _ = gen_history(H, R, 0.03, 0.02, B, seed=21)
    kw = dict(n_windows=NW, microbatches=4, max_iter=16)
    want = jax_rounds(H, W, 0.03, 0.02, mesh=jax_make_mesh(D, axis_name="rounds"),
                      use_pallas=False, **kw)(syn)
    got = make_rounds_sharded_window_decoder(
        H, W, 0.03, 0.02, mesh=cpu_mesh(D, "rounds"), **kw)(syn)
    plain = make_window_decoder(H, W, 0.03, 0.02, max_iter=16, device="cpu")(syn)
    np.testing.assert_array_equal(got.correction.numpy(), np.asarray(want.correction))
    np.testing.assert_array_equal(got.bp_iterations.numpy(), np.asarray(want.bp_iterations))
    assert torch.equal(got.correction, plain.correction)
    assert torch.equal(got.bp_iterations, plain.bp_iterations)


@pytest.mark.parametrize("D,postprocess", [(2, "osd0"), (4, "lsd0")])
def test_rounds_sharded_surface_code(D, postprocess):
    """A surface code whose windows leave lanes to the post-processor:
    equal to the single-device window decoder (OSD-0 and LSD-0)."""
    H = surface_code(3).hx
    W, B, NW = 4, 12, 4
    R = (NW + 1) * (W // 2)
    syn, _ = gen_history(H, R, 0.06, 0.04, B, seed=5)
    kw = dict(max_iter=6, postprocess=postprocess)
    got = make_rounds_sharded_window_decoder(
        H, W, 0.06, 0.04, mesh=cpu_mesh(D, "rounds"), n_windows=NW, microbatches=3, **kw)(syn)
    plain = make_window_decoder(H, W, 0.06, 0.04, device="cpu", **kw)(syn)
    assert torch.equal(got.correction, plain.correction)
    assert torch.equal(got.bp_iterations, plain.bp_iterations)


def test_rounds_sharded_rejects_uneven_windows_and_batches():
    H = rep_code(6)
    with pytest.raises(ValueError, match="divide evenly"):
        make_rounds_sharded_window_decoder(H, 4, 0.03, 0.02, mesh=cpu_mesh(3, "rounds"),
                                           n_windows=8)
    dec = make_rounds_sharded_window_decoder(H, 4, 0.03, 0.02, mesh=cpu_mesh(2, "rounds"),
                                             n_windows=8, microbatches=4)
    syn, _ = gen_history(H, 18, 0.03, 0.02, 6, seed=1)
    with pytest.raises(ValueError, match="microbatches"):
        dec(syn)
    with pytest.raises(ValueError, match="expected"):
        dec(syn[:4, :, :16])


# ---- the pipeline ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline_workload():
    code = surface_code(5)
    H = np.asarray(code.hx.todense(), np.uint8)
    rng = np.random.default_rng(17)
    errors = (rng.random((600, H.shape[1])) < 0.08).astype(np.uint8)
    return code, H, (errors @ H.T % 2).astype(np.uint8)


PIPELINE_CASES = {
    "stage_batch": (lambda: jax_pipeline_mesh(), lambda: make_pipeline_mesh(devices=["cpu"] * 8),
                    128, 600, True),
    "stage_only": (lambda: JaxMesh(np.asarray(jax.devices()[:2]), ("stage",)),
                   lambda: Mesh(["cpu"] * 2, ("stage",)), 100, 250, True),
    "bp_only": (lambda: jax_pipeline_mesh(), lambda: make_pipeline_mesh(devices=["cpu"] * 8),
                128, 600, False),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_pipeline_matches_jax(pipeline_workload, case):
    code, H, syn = pipeline_workload
    jmesh, tmesh, mb, rows, run_osd = PIPELINE_CASES[case]
    kw = dict(microbatch_size=mb, max_iter=12, run_osd=run_osd)
    want = jax_pipelined(code.hx, 0.08, mesh=jmesh(), **kw)(syn[:rows])
    got = make_pipelined_decoder(code.hx, 0.08, mesh=tmesh(), **kw)(syn[:rows])
    assert got.shape == (rows, H.shape[1]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if run_osd:
        np.testing.assert_array_equal(got, _reference_decode(code, syn[:rows]))
        assert ((got.astype(np.int64) @ H.T) % 2 == syn[:rows]).all()


def test_pipeline_rejects_bad_meshes(pipeline_workload):
    code, _, _ = pipeline_workload
    with pytest.raises(ValueError, match="stage"):
        make_pipelined_decoder(code.hx, 0.08, mesh=Mesh(["cpu"], ("stage",)))
    with pytest.raises(ValueError, match="at least 2"):
        make_pipeline_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="divide"):
        make_pipelined_decoder(code.hx, 0.08, mesh=make_pipeline_mesh(devices=["cpu"] * 6),
                               microbatch_size=100)


# ---- tensor-parallel BP ------------------------------------------------------------


def _tp_workload(seed=0, B=32, p=0.05, code=None):
    pcm = surface_code(5).hx if code is None else code
    H = np.asarray(pcm.todense(), np.uint8)
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return pcm, H, (errors @ H.T % 2).astype(np.uint8)


def _assert_tp_rule(got, ref):
    """tests/test_tensor_parallel.py:48-62's rule."""
    conv = np.asarray(ref.converged)
    np.testing.assert_array_equal(np.asarray(got.converged), conv)
    np.testing.assert_array_equal(np.asarray(got.iterations), np.asarray(ref.iterations))
    np.testing.assert_array_equal(np.asarray(got.decoding)[conv], np.asarray(ref.decoding)[conv])
    np.testing.assert_allclose(np.asarray(got.llr_posterior), np.asarray(ref.llr_posterior),
                               rtol=2e-4, atol=2e-4)


TP_CASES = {
    "code8": (lambda: JaxMesh(np.asarray(jax.devices()), ("code",)),
              lambda: Mesh(["cpu"] * 8, ("code",)), None, 32),
    "batch4_code2": (lambda: JaxMesh(np.asarray(jax.devices()).reshape(4, 2), ("batch", "code")),
                     lambda: Mesh(np.array(["cpu"] * 8, dtype=object).reshape(4, 2),
                                  ("batch", "code")), None, 30),
    "uneven_hamming3": (lambda: JaxMesh(np.asarray(jax.devices()), ("code",)),
                        lambda: Mesh(["cpu"] * 8, ("code",)), hamming_code(3), 16),
}


@pytest.mark.parametrize("method", [tbp.MINIMUM_SUM, tbp.PRODUCT_SUM])
@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_bp_matches_jax_and_k1(case, method):
    jmesh, tmesh, code, B = TP_CASES[case]
    pcm, H, syn = _tp_workload(seed=3, B=B, p=0.08, code=code)
    graph = compile_pcm(pcm)
    llr = jbp.channel_llr(np.full(graph.n, 0.08))
    kw = dict(bp_method=method, max_iter=20, ms_scaling_factor=0.625)
    want = jax_tp(graph, jmesh(), **kw)(syn, np.asarray(llr))
    got = make_tp_bp_decoder(graph, tmesh(), **kw)(syn, llr)
    _assert_tp_rule(got, want)
    k1 = tbp.make_parallel_decoder(graph, method, 20, 0.625, "cpu")(
        torch.from_numpy(syn), torch.from_numpy(llr))
    _assert_tp_rule(got, k1)


def test_tp_bp_dynamic_factor_and_per_lane_prior():
    """Min-sum with the factor 0 (1 - 2^-it) and a (B, n) prior: K1''s
    plain version under the same rule."""
    pcm, H, syn = _tp_workload(seed=4, B=24, p=0.06)
    graph = compile_pcm(pcm)
    prior = (0.5 + 5 * np.random.default_rng(4).random((24, graph.n))).astype(np.float32)
    got = make_tp_bp_decoder(graph, Mesh(["cpu"] * 4, ("code",)), max_iter=15,
                             ms_scaling_factor=0.0)(syn, prior)
    k1 = tbp.make_parallel_decoder(graph, tbp.MINIMUM_SUM, 15, 0.0, "cpu")(
        torch.from_numpy(syn), torch.from_numpy(prior))
    _assert_tp_rule(got, k1)


def test_tp_decoder_class_valid_decodings():
    pcm, H, syn = _tp_workload(seed=2)
    dec = TpBpDecoder(pcm, Mesh(["cpu"] * 8, ("code",)), error_rate=0.05, max_iter=25,
                      bp_method="ms", ms_scaling_factor=0.625)
    out = dec.decode_batch(syn)
    conv = dec.converged
    assert conv.sum() > 0
    assert ((out[conv].astype(np.int64) @ H.T) % 2 == syn[conv]).all()
    assert dec.decode(syn[0]).shape == (H.shape[1],)
    with pytest.raises(ValueError, match="expected 'code'"):
        make_tp_bp_decoder(compile_pcm(pcm), cpu_mesh(2))


# ---- the sharded Monte-Carlo and QSS steps ---------------------------------------


MC_KW = dict(rounds_per_call=2, max_iter=6, ms_scaling_factor=0.625)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_mc_step_is_the_sum_of_its_entries(D):
    code = surface_code(3, compute_logicals=True)
    step, runs = make_sharded_mc_step(code.hx, 0.05, mesh=cpu_mesh(D), batch_size_per_device=128,
                                      logicals=code.lx, **MC_KW)
    local, runs_local = make_mc_decoder_step(code.hx, 0.05, batch_size=128, logicals=code.lx,
                                             device="cpu", **MC_KW)
    gen = torch.Generator()
    gen.manual_seed(123)
    got = step(gen)
    gen.manual_seed(123)
    gens = step.generators(gen)
    assert len(gens) == D and runs == D * runs_local == int(got[0])
    want = sum(local(g) for g in gens)
    assert torch.equal(got, want)
    # the entries draw distinct streams, and a second call moves on
    assert len({g.initial_seed() for g in gens}) == D
    assert not torch.equal(step(gen), got) or D == 1


def test_sharded_mc_1_vs_8_statistics_against_jax():
    """8 entries of 512 lanes against JAX's 8-device and 1-device steps of
    the same runs: logical error rates within 5 binomial sigmas (JAX's own
    1-vs-8 test's bound), the port's streams being torch's."""
    code = surface_code(3, compute_logicals=True)
    kw = dict(logicals=code.lx, **MC_KW)
    step8, runs8 = make_sharded_mc_step(code.hx, 0.08, mesh=cpu_mesh(8),
                                        batch_size_per_device=512, **kw)
    step1, runs1 = make_sharded_mc_step(code.hx, 0.08, mesh=cpu_mesh(1),
                                        batch_size_per_device=4096, **kw)
    gen = torch.Generator()
    gen.manual_seed(7)
    c8 = step8(gen).numpy().astype(np.float64)
    c1 = step1(gen).numpy().astype(np.float64)
    jstep, jruns = jax_sharded_mc(code.hx, 0.08, mesh=jax_make_mesh(8),
                                  batch_size_per_device=512, **kw)
    cj = np.asarray(jstep(jax.random.key(7)), np.float64)
    assert runs8 == runs1 == jruns == c8[0] == c1[0] == cj[0]
    rates = [c[1] / c[0] for c in (c8, c1, cj)]
    for a in rates:
        for b in rates:
            pbar = (a + b) / 2
            sigma = np.sqrt(max(2 * pbar * (1 - pbar) / runs8, 1e-12))
            assert abs(a - b) <= max(5 * sigma, 16 / runs8), rates


QSS_KW = dict(repetitions=4, rounds=8, max_iter=8)


@pytest.mark.parametrize("D", [2, 3])
def test_sharded_qss_step_is_the_sum_of_its_entries(D):
    code = surface_code(3, compute_logicals=True)
    step, runs = make_sharded_qss_step(code.hx, 0.03, 0.03, code.lx, mesh=cpu_mesh(D),
                                       batch_size_per_device=16, **QSS_KW)
    local, runs_local = make_qss_step(code.hx, 0.03, 0.03, code.lx, batch_size=16,
                                      device="cpu", **QSS_KW)
    gen = torch.Generator()
    gen.manual_seed(1)
    got = step(gen)
    gen.manual_seed(1)
    want = sum(local(g) for g in step.generators(gen))
    assert runs == D * runs_local == int(got[0]) == 16 * D
    assert torch.equal(got, want)
    assert int(got[3]) == 16 * D * 3  # 3 windows a shot


def test_sharded_qss_1_vs_8_statistics_against_jax():
    """The QSS twin of the MC statistics test: 8 entries of 128 shots and 1
    of 1024 against JAX's 8-device step, at a noise level where about a
    quarter of the shots fail. Runs and windows decoded are equal, the
    counter layouts are JAX's ``[runs, fails, bp_iters, windows]``, and the
    logical error rates agree within 5 binomial sigmas."""
    code = surface_code(3, compute_logicals=True)
    step8, runs8 = make_sharded_qss_step(code.hx, 0.05, 0.05, code.lx, mesh=cpu_mesh(8),
                                         batch_size_per_device=128, **QSS_KW)
    step1, runs1 = make_sharded_qss_step(code.hx, 0.05, 0.05, code.lx, mesh=cpu_mesh(1),
                                         batch_size_per_device=1024, **QSS_KW)
    gen = torch.Generator()
    gen.manual_seed(7)
    c8 = step8(gen).numpy().astype(np.float64)
    c1 = step1(gen).numpy().astype(np.float64)
    jstep, jruns = jax_sharded_qss(code.hx, 0.05, 0.05, code.lx, mesh=jax_make_mesh(8),
                                   batch_size_per_device=128, **QSS_KW)
    cj = np.asarray(jstep(jax.random.key(7)), np.float64)
    assert c8.shape == c1.shape == cj.shape == (4,)
    assert runs8 == runs1 == jruns == c8[0] == c1[0] == cj[0] == 1024
    assert c8[3] == c1[3] == cj[3] == 1024 * 3  # 3 windows a shot
    rates = [c[1] / c[0] for c in (c8, c1, cj)]
    assert min(rates) > 0.1, rates  # shots do fail at this noise
    for a in rates:
        for b in rates:
            pbar = (a + b) / 2
            sigma = np.sqrt(2 * pbar * (1 - pbar) / runs8)
            assert abs(a - b) <= 5 * sigma, rates


def test_sharded_steps_take_the_mesh_not_a_device():
    code = surface_code(3, compute_logicals=True)
    with pytest.raises(TypeError, match="mesh"):
        make_sharded_mc_step(code.hx, 0.05, mesh=cpu_mesh(2), device="cpu")
