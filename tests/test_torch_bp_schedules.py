"""The port's serial, soft-information, fold-exact and single-scan BP
engines (the plain versions of K6', K7', K8' and K1' with a fixed factor)
held against the JAX package's engines on the CPU.

Inputs are made with numpy from a seed and fed to both sides. Tolerances:

- min-sum: flags identical on every lane. In float64 (and wherever the
  factor is 1) decisions and iteration counts identical on every lane and
  posteriors within 1e-12 relative (identical at factor 1). The port folds
  ``llr + alpha * c`` with two roundings, as the reference C++ does (the
  port equals ``tests/fixtures/bp_golden.npz`` bit for bit, see
  test_torch_bp_decoders.py); XLA contracts that multiply-add in the JAX
  serial and soft-information loops into one rounding (ROADMAP queue 3).
  In float32 that ulp is large enough to move a lane's trajectory at an fp
  tie, so decisions and iterations are identical on at least 97% of lanes
  (on surface d=5, 1 or 2 of 96 differ) and posteriors within 1e-5 on the
  lanes that agree. Serial-relative ranks the posteriors, and equal
  posteriors are common, so an ulp reorders the schedule: in float32 it is
  held to identical flags and converged decisions that solve H x = s (7 of
  96 lanes take another path at factor 0), in float64 as above with the
  posteriors on converged lanes. The witness that the contraction is the
  only difference: under the serial-relative and random schedules each
  float32 case also runs the plain version with that one step rounded once
  (:func:`_contracted`), which must equal JAX bit for bit on every lane,
  posteriors included. JAX's fixed-order serial and soft-information
  programs contract only some of those adds (no one rule reproduces them;
  the readings are in ROADMAP queue 3), so they keep the tiers above.
- product-sum: flags exact; decisions exact on converged lanes (serial) or
  every lane (parallel); serial-relative statistically (converged counts
  within 2 and every converged decision solves H x = s). These are
  tests/test_bp_golden.py's tiers: the tanh/log of two libraries differ by
  an ulp, which saturated lanes amplify.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldpc_tpu.codes import (
    bivariate_bicycle_code, hamming_code, rep_code, ring_code, surface_code)
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import bp as tbp
from ldpc_tpu_torch.ops import bp_cuda, bp_fold
from ldpc_tpu_torch.ops.pcm import graph_to_torch

torch.set_num_threads(1)

MAX_ITER = 20
# (name, pcm, error rate, batch)
CODES = {
    "surface3": (lambda: surface_code(3).hx, 0.05, 64),
    "surface5": (lambda: surface_code(5).hx, 0.05, 96),
    "hamming3": (lambda: hamming_code(3), 0.1, 64),
    "rep7": (lambda: rep_code(7), 0.1, 48),
    "ring8": (lambda: ring_code(8), 0.1, 64),
    # the gross [[144,12,12]] code's hx (three checks a bit) and the d=13
    # main path's code, where the card tests hold K8' to this plain version
    "gross": (lambda: bivariate_bicycle_code(12, 6, [(3, 0), (0, 1), (0, 2)],
                                             [(0, 3), (1, 0), (2, 0)]).hx, 0.03, 24),
    "surface13": (lambda: surface_code(13).hx, 0.01, 24),
}
MODES = {"serial": (jbp.SERIAL, False), "relative": (jbp.SERIAL_RELATIVE, False),
         "random": (jbp.SERIAL, True)}
METHODS = {"ms1.0": (jbp.MINIMUM_SUM, 1.0), "ms0.625": (jbp.MINIMUM_SUM, 0.625),
           "ms0.0": (jbp.MINIMUM_SUM, 0.0), "ps": (jbp.PRODUCT_SUM, 1.0)}
DTYPES = {"f32": (np.float32, jnp.float32), "f64": (np.float64, jnp.float64)}


def make_workloads():
    """(graph, syndromes, channel LLRs in float64) of each code, from numpy
    seed 7."""
    out = {}
    for name, (build, p, B) in CODES.items():
        graph = compile_pcm(build())
        rng = np.random.default_rng(7)
        errors = (rng.random((B, graph.n)) < p).astype(np.uint8)
        syn = (errors @ graph.dense.T % 2).astype(np.uint8)
        out[name] = (graph, syn, jbp.channel_llr(np.full(graph.n, p), np.float64))
    return out


@pytest.fixture(scope="module")
def workloads():
    return make_workloads()


def _jax_table(key, n, iters):
    """JAX's random serial schedule: the permutation of iteration it is
    drawn from fold_in(key, it), it = 1..iters."""
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.fold_in(key, it), n))
        for it in range(1, iters + 1)
    ]).astype(np.int32)


def _run_serial(workloads, name, method, mode, dtype):
    graph, syn, llr = workloads[name]
    bp_method, alpha = METHODS[method]
    (sched_mode, rnd), (np_dt, j_dt) = MODES[mode], DTYPES[dtype]
    order = np.random.default_rng(1).permutation(graph.n).astype(np.int32)
    key = jax.random.key(3)
    rj = jbp.make_serial_decoder(graph, bp_method, MAX_ITER, alpha, schedule_mode=sched_mode,
                                 random_serial_schedule=rnd, dtype=j_dt)(
        jnp.asarray(syn), jnp.asarray(llr.astype(np_dt)), jnp.asarray(order), key)

    def port():
        rt = tbp.make_serial_decoder(graph, bp_method, MAX_ITER, alpha, "cpu",
                                     schedule_mode=sched_mode, random_serial_schedule=rnd,
                                     dtype=np_dt)(
            syn, llr.astype(np_dt), order,
            torch.from_numpy(_jax_table(key, graph.n, MAX_ITER)))
        return [x.numpy() for x in rt]

    return graph, syn, [np.asarray(x) for x in rj], port


@contextlib.contextmanager
def _contracted(monkeypatch):
    """The float32 plain versions with ``x + alpha * c`` rounded once, as
    XLA contracts it in JAX's serial-relative and random serial loops: the
    factor comes back as a (1,) float64 tensor, so each c2v value is the
    exact product in float64, and every add of a c2v value to a float32 sum
    (the posterior's left fold, the suffix) is rounded once; a message's
    partial plus suffix stays a float32 add."""
    alpha = bp_fold._alpha

    def alpha_exact(*args, **kwargs):
        a = alpha(*args, **kwargs)
        return a.to(torch.float64).reshape(1) if a.dtype == torch.float32 else a

    def fold_bit(llr0, c2v, vmask):
        def add(x, k):
            return torch.where(vmask[:, k], (x.double() + c2v[:, k]).to(x.dtype), x)

        acc, partials = llr0, []
        for k in range(c2v.shape[1]):
            partials.append(acc)
            acc = add(acc, k)
        suf, slots = torch.zeros_like(llr0), [None] * c2v.shape[1]
        for k in reversed(range(c2v.shape[1])):
            slots[k] = partials[k] + suf
            suf = add(suf, k)
        return acc, torch.stack(slots, dim=1)

    with monkeypatch.context() as mp:
        mp.setattr(bp_fold, "_alpha", alpha_exact)
        mp.setattr(bp_fold, "_fold_bit", fold_bit)
        yield


@contextlib.contextmanager
def _jax_tanh_log(monkeypatch):
    """``torch.tanh`` and ``torch.log`` computed by JAX (XLA's CPU
    functions), so the plain product-sum takes the same transcendental
    values as JAX's engine: what is left between the two is the rest of
    the arithmetic."""
    def via_jax(fn):
        return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))

    with monkeypatch.context() as mp:
        mp.setattr(torch, "tanh", via_jax(jnp.tanh))
        mp.setattr(torch, "log", via_jax(jnp.log))
        yield


def _run_exact(workloads, name, method, max_iter=MAX_ITER):
    """JAX's float64 parallel BP on a workload (numpy outputs) and a
    callable that runs the port's plain version on it."""
    graph, syn, llr = workloads[name]
    bp_method, alpha = METHODS[method]
    rj = jbp.make_parallel_decoder(graph, bp_method, max_iter, alpha, dtype=jnp.float64)(
        jnp.asarray(syn), jnp.asarray(llr))

    def port():
        rt = tbp.make_parallel_decoder(graph, bp_method, max_iter, alpha, "cpu",
                                       dtype=torch.float64)(syn, llr)
        return [x.numpy() for x in rt]

    return [np.asarray(x) for x in rj], port


def _assert_contracted_equals_jax(monkeypatch, port, rj):
    """Every output of ``port()`` under :func:`_contracted` equals JAX's on
    every lane, bit for bit."""
    with _contracted(monkeypatch):
        rc = port()
    for a, b in zip(rc, rj):
        np.testing.assert_array_equal(a, b)


def _assert_min_sum(rj, rt, alpha, dtype, relative=False, graph=None, syn=None):
    np.testing.assert_array_equal(rt[2], rj[2])
    same = (rt[0] == rj[0]).all(axis=1) & (rt[3] == rj[3])
    exact = dtype == "f64" or alpha == 1.0
    if relative and not exact:
        dec = rt[0][rt[2]].astype(np.int64)
        assert ((dec @ graph.dense.T % 2) == syn[rt[2]]).all()
        return
    if exact:
        assert same.all(), f"{int((~same).sum())} lanes differ"
    else:
        assert same.mean() >= 0.97, f"{int((~same).sum())} of {same.size} lanes differ"
    if relative:
        same = same & rj[2]
    lj, lt = rj[1][same], rt[1][same]
    if alpha == 1.0 and not relative:
        np.testing.assert_array_equal(lt, lj)
    else:
        tol = 1e-12 if dtype == "f64" else 1e-5
        np.testing.assert_allclose(lt, lj, rtol=tol, atol=tol)


def _assert_product_sum(graph, syn, rj, rt, mode):
    conv_j, conv_t = rj[2], rt[2]
    if mode == "relative":
        assert abs(int(conv_j.sum()) - int(conv_t.sum())) <= 2
        dec = rt[0][conv_t]
        assert ((dec.astype(np.int64) @ graph.dense.T % 2) == syn[conv_t]).all()
        return
    np.testing.assert_array_equal(conv_t, conv_j)
    np.testing.assert_array_equal(rt[0][conv_j], rj[0][conv_j])
    np.testing.assert_array_equal(rt[3][conv_j], rj[3][conv_j])


# every mode x method x dtype on surface d=5; the smaller codes a cross
# section (each case compiles one JAX program)
SERIAL_CASES = [("surface5", meth, mode, dt) for mode in MODES for meth, dt in (
    ("ms1.0", "f64"), ("ms0.625", "f32"), ("ms0.625", "f64"), ("ms0.0", "f32"),
    ("ps", "f32"), ("ps", "f64"))] + [
    (name, meth, mode, dt) for name in ("surface3", "hamming3", "rep7", "ring8")
    for mode, meth, dt in (("serial", "ms0.625", "f64"), ("relative", "ms0.625", "f32"),
                           ("random", "ms0.0", "f64"), ("serial", "ps", "f32"))]


@pytest.mark.parametrize("name,method,mode,dtype", SERIAL_CASES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_serial_engine_matches_jax(workloads, monkeypatch, name, method, mode, dtype):
    graph, syn, rj, port = _run_serial(workloads, name, method, mode, dtype)
    rt = port()
    assert rt[1].dtype == DTYPES[dtype][0]
    assert rt[0].dtype == np.uint8 and rt[0].shape == syn.shape[:1] + (graph.n,)
    bp_method, alpha = METHODS[method]
    if bp_method == jbp.MINIMUM_SUM:
        _assert_min_sum(rj, rt, alpha, dtype, mode == "relative", graph, syn)
        if dtype == "f32" and alpha != 1.0 and mode != "serial":
            _assert_contracted_equals_jax(monkeypatch, port, rj)
    else:
        _assert_product_sum(graph, syn, rj, rt, mode)


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_serial_engine_short_runs(workloads, max_iter):
    """A lane stopped at max_iter reports that iteration's state; max_iter
    0 returns the channel LLRs and zero decisions."""
    graph, syn, llr = workloads["surface5"]
    rj = jbp.make_serial_decoder(graph, jbp.MINIMUM_SUM, max_iter, 1.0, dtype=jnp.float64)(
        jnp.asarray(syn), jnp.asarray(llr), jnp.arange(graph.n, dtype=jnp.int32),
        jax.random.key(0))
    rt = tbp.make_serial_decoder(graph, jbp.MINIMUM_SUM, max_iter, 1.0, "cpu",
                                 dtype=torch.float64)(syn, llr)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["surface5", "ring8"])
def test_soft_info_engine_matches_jax(workloads, name, dtype):
    """Decodings, flags and iterations identical; posteriors and the final
    soft syndrome within the min-sum tolerance (the soft syndrome's shrink
    reads messages that JAX rounds once)."""
    graph, syn, llr = workloads[name]
    np_dt, j_dt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    soft = (1 - 2 * syn.astype(np.float64)) + 0.3 * rng.standard_normal(syn.shape)
    rj, sj = jbp.make_soft_info_decoder(graph, MAX_ITER, 0.625, dtype=j_dt)(
        jnp.asarray(soft.astype(np_dt)), jnp.asarray(llr.astype(np_dt)), 10.0, 0.3)

    rt, st = tbp.make_soft_info_decoder(graph, MAX_ITER, 0.625, "cpu", dtype=np_dt)(
        soft, llr, 10.0, 0.3)
    rj = [np.asarray(x) for x in rj]
    _assert_min_sum(rj, [x.numpy() for x in rt], 0.625, dtype)
    tol = 1e-12 if dtype == "f64" else 1e-6
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=tol, atol=tol)
    # the virtual-update rules fired: some check's soft value changed
    assert (st.numpy() != soft.astype(np_dt) * np_dt(2 / 0.09)).any()


def test_soft_info_engine_without_rules_is_serial_min_sum(workloads):
    """cutoff 0 disables the rules: K7's plain version is then serial
    min-sum in index order on the hard syndrome, with the same factor."""
    graph, syn, llr = workloads["surface5"]
    soft = np.where(syn == 1, -20.0, 20.0)
    rt, st = tbp.make_soft_info_decoder(graph, MAX_ITER, 0.625, "cpu", dtype=torch.float64)(
        soft, llr, 0.0, 2.0)
    rs = tbp.make_serial_decoder(graph, jbp.MINIMUM_SUM, MAX_ITER, 0.625, "cpu",
                                 dtype=torch.float64)(syn, llr)
    for a, b in zip(rt, rs):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(st.numpy(), soft * 0.5)


@pytest.mark.parametrize("method", ["ms0.625", "ms0.0", "ps"])
@pytest.mark.parametrize("name", ["surface3", "surface5", "hamming3", "ring8", "gross",
                                  "surface13"])
def test_exact_engine_matches_jax(workloads, monkeypatch, name, method):
    """K8's plain version against ``_make_parallel_decoder_exact``: min-sum
    bit for bit (the parallel fold leaves XLA nothing to contract);
    product-sum decisions, flags and iterations exact, posteriors within
    1e-9 (the tanh/log ulp). On the gross code and surface d=13 the two
    libraries' tanh/log differ by an ulp that BP amplifies on a lane that
    never converges (the largest posterior gap 1e-14 after one iteration
    of the gross code, 5e-9 after five, order 1 by 20:
    ``tools/jax_contraction_readings.py``), so there the posteriors are
    held within 1e-9 on the lanes that converge, and every output of every
    lane bit for bit with JAX's tanh and log in the plain version."""
    rj, port = _run_exact(workloads, name, method)
    rt = port()
    assert rt[1].dtype == np.float64
    for i in (0, 2, 3):
        np.testing.assert_array_equal(rt[i], rj[i])
    if METHODS[method][0] == jbp.MINIMUM_SUM:
        np.testing.assert_array_equal(rt[1], rj[1])
    elif name in ("gross", "surface13"):
        conv = rj[2].astype(bool)
        assert conv.sum() >= len(conv) // 2
        np.testing.assert_allclose(rt[1][conv], rj[1][conv], rtol=1e-9, atol=1e-9)
        with _jax_tanh_log(monkeypatch):
            rw = port()
        for a, b in zip(rw, rj):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(rt[1], rj[1], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("max_iter", [1, 5])
@pytest.mark.parametrize("name", ["gross", "surface13"])
def test_exact_product_sum_gap_is_tanh_log(workloads, monkeypatch, name, max_iter):
    """Product-sum after 1 and 5 iterations on the codes where the gap to
    JAX grows on lanes that never converge: with JAX's tanh and log in the
    plain version every output of every lane equals JAX's bit for bit, and
    without them the posteriors stay within what the ulp has grown to by
    then (1e-13 after one iteration, 1e-7 after five)."""
    rj, port = _run_exact(workloads, name, "ps", max_iter)
    rt = port()
    for i in (0, 2, 3):
        np.testing.assert_array_equal(rt[i], rj[i])
    assert (~rj[2].astype(bool)).any()
    tol = 1e-13 if max_iter == 1 else 1e-7
    np.testing.assert_allclose(rt[1], rj[1], rtol=tol, atol=tol)
    with _jax_tanh_log(monkeypatch):
        rw = port()
    for a, b in zip(rw, rj):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha", [0.625, 0.0])
@pytest.mark.parametrize("name", ["surface5", "hamming3"])
def test_single_scan_engine_matches_jax(workloads, name, alpha):
    """K1's plain version with its dynamic factor off against
    ``make_single_scan_decoder``, in float32 and float64; at factor 0 every
    message is 0."""
    graph, syn, llr = workloads[name]
    llr32 = llr.astype(np.float32)
    rj = jbp.make_single_scan_decoder(graph, MAX_ITER, alpha)(jnp.asarray(syn),
                                                              jnp.asarray(llr32))
    rt = tbp.make_single_scan_decoder(graph, MAX_ITER, alpha, "cpu")(syn, llr32)
    for i, (a, b) in enumerate(zip(rj, rt)):
        if i == 1:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if alpha == 0.0:
        np.testing.assert_array_equal(rt.llr_posterior.numpy(),
                                      np.broadcast_to(llr32, rt.llr_posterior.shape))
    # float64: K1''s float64 instance's plain version, bit for bit
    rj64 = jbp.make_single_scan_decoder(graph, MAX_ITER, alpha, dtype=jnp.float64)(
        jnp.asarray(syn), jnp.asarray(llr))
    rt64 = tbp.make_single_scan_decoder(graph, MAX_ITER, alpha, "cpu", dtype=torch.float64)(
        syn, llr)
    assert rt64.llr_posterior.dtype == torch.float64
    for a, b in zip(rj64, rt64):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_relative_order_is_a_stable_descending_rank():
    """Serial-relative ranks most reliable first, equal keys in index
    order, +inf first, NaN last: torch.argsort(-llr, stable=True)."""
    llr = torch.tensor([[1.0, float("inf"), 1.0, -2.0, float("nan"), 3.0, 1.0]])
    order = torch.argsort(-llr, dim=1, stable=True)
    assert order.tolist() == [[1, 5, 0, 2, 6, 3, 4]]


def test_order_table_and_generator(workloads):
    """The random serial table: one permutation per iteration, int32,
    drawn from the generator (the same seed gives the same table); seed 0
    reads the clock."""
    g1 = tbp.schedule_generator(11, "cpu")
    g2 = tbp.schedule_generator(11, "cpu")
    t1 = tbp.serial_order_table(41, 5, g1, "cpu")
    t2 = tbp.serial_order_table(41, 5, g2, "cpu")
    assert t1.dtype == torch.int32 and t1.shape == (5, 41)
    assert torch.equal(t1, t2)
    assert (torch.sort(t1, dim=1).values == torch.arange(41)).all()
    assert tbp.serial_order_table(41, 0, g1, "cpu").shape == (0, 41)
    tbp.schedule_generator(0, "cpu")  # the clock: must not raise


def test_fold_dispatch_runs_plain_versions_on_cpu(workloads):
    """On a CPU tensor each dispatcher runs its plain version and counts
    no launch; a CUDA-only wrapper refuses the CPU; other devices raise."""
    graph, syn, llr = workloads["surface3"]
    tg = graph_to_torch(graph, "cpu")
    s = torch.from_numpy(syn)
    l64 = torch.from_numpy(llr)
    order = torch.arange(graph.n, dtype=torch.int32)
    before = {k: dict(v) for k, v in bp_fold.STATE_LAUNCHES.items()}
    launches = dict(bp_fold.LAUNCHES)
    cases = (
        (bp_fold.bp_serial, bp_fold.bp_serial_reference, bp_fold.bp_serial_cuda,
         (tg, s, l64, jbp.MINIMUM_SUM, 8, 0.625, order, bp_fold.ORDER_FIXED)),
        (bp_fold.bp_soft_info, bp_fold.bp_soft_info_reference, bp_fold.bp_soft_info_cuda,
         (tg, (1 - 2 * s.double()) * 10, l64, 8, 0.625, 5.0)),
        (bp_fold.bp_parallel_exact, bp_fold.bp_parallel_exact_reference,
         bp_fold.bp_parallel_exact_cuda, (tg, s, l64, jbp.MINIMUM_SUM, 8, 0.625)),
    )
    for dispatch, plain, cuda, args in cases:
        a, b = dispatch(*args), plain(*args)
        flat_a = list(a[0]) + [a[1]] if isinstance(a, tuple) and len(a) == 2 else list(a)
        flat_b = list(b[0]) + [b[1]] if isinstance(b, tuple) and len(b) == 2 else list(b)
        for x, y in zip(flat_a, flat_b):
            assert torch.equal(x, y)
        with pytest.raises(ValueError, match="CUDA"):
            cuda(*args)
        meta = (args[0], args[1].to("meta")) + args[2:]
        with pytest.raises(ValueError, match="no kernel"):
            dispatch(*meta)
    assert bp_fold.LAUNCHES == launches
    assert bp_fold.STATE_LAUNCHES == before
    # K1' with its factor fixed: the dispatcher passes the flag through
    a = bp_cuda.bp_parallel(tg, s, l64.float(), jbp.MINIMUM_SUM, 8, 0.0, dynamic_alpha=False)
    assert (a.llr_posterior == l64.float()).all()
