"""The port's circuit-level decoding (``ldpc_tpu_torch.ckt_noise``) held
against the JAX package's on the CPU, on the duck-typed detector error
models of tests/test_ckt_noise.py (stim is not installed) and on a
phenomenological memory DEM of the surface code built the same way.

- DEM conversion: all six ``DemMatrices`` fields bit for bit, hyperedge
  decomposition and merged mechanisms included.
- Edge colouring: ``bipartite_edge_coloring`` bit for bit, the
  ``BipartiteGraph`` class and the legacy time-step helpers.
- ``analyze_uniform_windows``: every ``UniformWindows`` field.
- K1' with the +inf priors of committed look-back columns: the plain
  version gives no NaN and JAX's decisions, flags, iterations and
  posteriors (infinities included) at alpha 1.0; OSD-0's column order,
  ties at +inf included, equals JAX's stable argsort, and its decodings
  JAX's.
- ``make_device_owd`` on the same inputs as the JAX package's scan (the
  overlapping-window decoders end to end are in
  tests/test_torch_ckt_noise_owd.py), a boundary decoder built once, and
  an ``osd_order > 0`` case that keeps the host loop and warns (against
  the JAX package with its OSD-w weights summed over set bits).
- The weight-1 mechanism and batch-against-single checks of
  tests/test_ckt_noise.py on the port.
- The sinter overlapping-window adapters' compiled decoders, packed in and
  out, and ``count_logical_errors`` on a duck-typed circuit.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

import jax.numpy as jnp

import ldpc_tpu.ckt_noise as J
import ldpc_tpu_torch.ckt_noise as T
import ldpc_tpu.ckt_noise.sinter_overlapping_window_decoder as JOWD
import ldpc_tpu_torch.ckt_noise.sinter_overlapping_window_decoder as TOWD
from ldpc_tpu.ckt_noise import device_scan as jscan
from ldpc_tpu.ckt_noise.css_code_memory_circuit import (
    _is_valid_time_steps_matrix as j_valid_steps,
)
from ldpc_tpu.codes import hamming_code, rep_code, surface_code
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops import osd as josd
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ckt_noise import device_scan as tscan
from ldpc_tpu_torch.ckt_noise.css_code_memory_circuit import (
    _is_valid_time_steps_matrix as t_valid_steps,
)
from ldpc_tpu_torch.ops import bp as tbp
from ldpc_tpu_torch.ops import gf2 as tgf2
from ldpc_tpu_torch.ops import osd as tosd
from ldpc_tpu_torch.parallel import window as twindow
from ldpc_tpu_torch.utils import profiling as pf
from test_ckt_noise import (
    MockDem,
    MockInstruction,
    MockTarget,
    error,
    rep_code_memory_dem,
)

torch.set_num_threads(1)


def surface_memory_dem(d=5, rounds=12, p=0.01, q=0.01):
    """Phenomenological memory DEM of ``surface_code(d).hx``, built as
    ``rep_code_memory_dem`` builds its own: per round a data flip at p of
    each bit flips that round's detectors of its checks (and observable 0
    where ``lx`` row 0 holds the bit); below the last round a measurement
    flip at q flips that detector in two consecutive rounds."""
    code = surface_code(d)
    H = np.asarray(code.hx.todense(), np.uint8)
    lx = np.asarray(code.lx.todense(), np.uint8)[0]
    m, n = H.shape
    ins = []
    for r in range(rounds):
        for j in range(n):
            dets = [r * m + c for c in np.flatnonzero(H[:, j])]
            ins.append(error(p, dets, (0,) if lx[j] else ()))
        if r < rounds - 1:
            for c in range(m):
                ins.append(error(q, [r * m + c, (r + 1) * m + c]))
    return MockDem(ins, m * rounds, 1), m


def _hyperedge_dem():
    t = [MockTarget("det", 0), MockTarget("det", 1), MockTarget("sep"), MockTarget("det", 2)]
    return MockDem([MockInstruction(0.1, t)], 3, 0)


def _merged_dem():
    """Two mechanisms on one detector set (priors compound), the first with
    a decomposition into two edges and an observable on each part."""
    t = [MockTarget("det", 0), MockTarget("obs", 0), MockTarget("sep"),
         MockTarget("det", 1), MockTarget("det", 2), MockTarget("obs", 1)]
    return MockDem(
        [MockInstruction(0.1, t), error(0.2, [1, 3]), error(0.05, [0, 1, 2], (0, 1)),
         error(0.3, [3])],
        4, 2,
    )


DEMS = {
    "basic": lambda: MockDem(
        [error(0.1, [0, 1], (0,)), error(0.2, [1, 2]), error(0.05, [0, 1], (0,))], 3, 1),
    "hyperedge": _hyperedge_dem,
    "undecomposed": lambda: MockDem([error(0.1, [0, 1, 2])], 3, 0),
    "merged": _merged_dem,
    "rep_memory": lambda: rep_code_memory_dem(n_checks=3, rounds=14),
    "surface5_memory": lambda: surface_memory_dem()[0],
}

FIELDS = ("check_matrix", "observables_matrix", "edge_check_matrix",
          "edge_observables_matrix", "hyperedge_to_edge_matrix")


def _same_sparse(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    for attr in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(a, attr), getattr(b, attr)), attr


@pytest.mark.parametrize("name", list(DEMS))
def test_dem_matrices_match_jax(name):
    allow = name in ("undecomposed", "merged")
    j = J.detector_error_model_to_check_matrices(DEMS[name](), allow_undecomposed_hyperedges=allow)
    t = T.detector_error_model_to_check_matrices(DEMS[name](), allow_undecomposed_hyperedges=allow)
    for field in FIELDS:
        _same_sparse(getattr(j, field), getattr(t, field))
    assert np.array_equal(j.priors, t.priors) and j.priors.dtype == t.priors.dtype


def test_dem_undecomposed_raises_like_jax():
    with pytest.raises(ValueError, match="decomposed"):
        T.detector_error_model_to_check_matrices(DEMS["undecomposed"]())


def _random_biadj(seed):
    rng = np.random.default_rng(seed)
    return csr_matrix((rng.random((8, 12)) < 0.4).astype(np.uint8))


COLOURED = {
    "rep6": lambda: rep_code(6),
    "hamming3": lambda: hamming_code(3),
    "surface5": lambda: surface_code(5).hx,
    "ones4x5": lambda: csr_matrix(np.ones((4, 5), np.uint8)),
    **{f"random{s}": (lambda s=s: _random_biadj(s)) for s in range(10)},
}


@pytest.mark.parametrize("name", list(COLOURED))
def test_bipartite_edge_coloring_matches_jax(name):
    mat = COLOURED[name]()
    j = J.bipartite_edge_coloring(mat)
    t = T.bipartite_edge_coloring(mat)
    _same_sparse(j, t)
    assert T.is_valid_bipartite_edge_coloring(mat, t)
    assert t_valid_steps(mat, t) == j_valid_steps(mat, j)
    bad = t.copy()
    bad.data[:] = 1
    assert t_valid_steps(mat, bad) == j_valid_steps(mat, bad)
    assert T.is_valid_bipartite_edge_coloring(mat, bad) == J.is_valid_bipartite_edge_coloring(
        mat, bad)


def test_bipartite_graph_and_legacy_helpers_match_jax():
    from ldpc_tpu.ckt_noise import not_an_arb_ckt_simulator as jsim
    from ldpc_tpu_torch.ckt_noise import not_an_arb_ckt_simulator as tsim

    H, L = tsim.rep_code(6)
    jH, jL = jsim.rep_code(6)
    _same_sparse(H, jH)
    _same_sparse(L, jL)
    graphs = []
    for mod in (J, T):
        g = mod.BipartiteGraph.from_biadjacency_matrix(H)
        g.bipartite_edge_coloring()
        g.assert_has_edge_coloring()
        graphs.append(g)
    assert graphs[1].degree == graphs[0].degree == 2
    for a, b in zip(graphs[0].a_nodes + graphs[0].b_nodes, graphs[1].a_nodes + graphs[1].b_nodes):
        assert a.colored_edges == b.colored_edges and not b.uncolored_edges
    _same_sparse(graphs[0].to_biadjacency_matrix(), graphs[1].to_biadjacency_matrix())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t_steps = tsim.get_stabilizer_time_steps(H)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert t_steps == jsim.get_stabilizer_time_steps(jH)


def test_stim_entry_points_stay_lazy():
    """Without stim the circuit generators raise ImportError when called,
    as the JAX package's do, and the package still imports."""
    from ldpc_tpu_torch.ckt_noise import not_an_arb_ckt_simulator as tsim

    assert T.make_css_code_memory_circuit.__module__.endswith("css_code_memory_circuit")
    code = surface_code(3)
    with pytest.raises(ImportError):
        T.make_css_code_memory_circuit(
            x_stabilizers=code.hx, z_stabilizers=code.hz, x_logicals=code.lx,
            z_logicals=code.lz, num_rounds=2, basis="Z")
    H, L = tsim.rep_code(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        steps, bits = tsim.get_stabilizer_time_steps(H)
        with pytest.raises(ImportError):
            tsim.stim_circuit_from_time_steps(H, L, steps, bits)
    with pytest.raises(AttributeError):
        T.no_such_entry_point  # noqa: B018


def _uniform_case(name):
    """(dem, decodings, window, commit, num_checks) of the two uniform DEMs."""
    if name == "rep3_r14":
        return rep_code_memory_dem(n_checks=3, rounds=14), 6, 4, 2, 3
    dem, m = surface_memory_dem()
    return dem, 5, 4, 2, m


@pytest.mark.parametrize("name", ["rep3_r14", "surface5_r12"])
def test_analyze_uniform_windows_matches_jax(name):
    dem, decodings, window, commit, nc = _uniform_case(name)
    mats = J.detector_error_model_to_check_matrices(dem, allow_undecomposed_hyperedges=True)
    j = jscan.analyze_uniform_windows(mats.check_matrix, decodings, window, commit, nc, mats.priors)
    t = tscan.analyze_uniform_windows(mats.check_matrix, decodings, window, commit, nc, mats.priors)
    assert j is not None and t is not None and j._fields == t._fields
    for field in j._fields:
        a, b = getattr(j, field), getattr(t, field)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype, field
        else:
            assert a == b and type(a) is type(b), field
    # too few windows, or a window wider than two commits: both refuse
    for args in ((3, window, commit), (decodings, 5, 2)):
        assert tscan.analyze_uniform_windows(mats.check_matrix, *args, nc, mats.priors) is None
        assert jscan.analyze_uniform_windows(mats.check_matrix, *args, nc, mats.priors) is None


def _surface_shots(B=256, seed=5):
    """(dem, kwargs, shots, errors, DemMatrices): B shots of the surface
    d=5 memory DEM at p=0.01, errors drawn from the DEM priors."""
    dem, m = surface_memory_dem()
    mats = T.detector_error_model_to_check_matrices(dem, allow_undecomposed_hyperedges=True)
    Hd = np.asarray(mats.check_matrix.todense(), np.uint8)
    rng = np.random.default_rng(seed)
    errs = (rng.random((B, Hd.shape[1])) < mats.priors).astype(np.uint8)
    shots = (errs @ Hd.T % 2).astype(np.uint8)
    kwargs = dict(decodings=5, window=4, commit=2, num_checks=m)
    return dem, kwargs, shots, errs, mats


class _ZeroTimesInfIsZero:
    """``jax.numpy`` with the two OSD-w weight contractions of
    ``ldpc_tpu/ops/osd.py`` summed over the solution's set bits only. The
    JAX package's einsums multiply every 0 bit by its weight, and a
    committed column's weight log(1/0) = +inf makes 0 * inf = NaN: every
    candidate of a window after the first weighs NaN, and argmin takes
    candidate 0 (the OSD-0 solution). The reference sums the set bits
    (osd.hpp:163-180), as the port's ``weigh_rows`` does."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, a, b, **kw):
        if spec == "bcn,bn->bc":
            return jnp.where(a != 0, b[:, None, :], jnp.zeros((), b.dtype)).sum(-1)
        if spec == "ck,bk->bc":
            return jnp.where(a[None] != 0, b[:, None, :], jnp.zeros((), b.dtype)).sum(-1)
        return jnp.einsum(spec, a, b, **kw)


def test_owd_higher_order_keeps_host_loop_and_warns(monkeypatch):
    """OSD-CS order 3 keeps the host loop and warns. The port equals the
    JAX package with its OSD-w weights summed over set bits (see
    ``_ZeroTimesInfIsZero``) on every lane but OSD-w ties: another
    solution of the same weight (ROADMAP queue 3)."""
    import ldpc_tpu.ops.osd as josd_module

    dem, kwargs, shots, _, mats = _surface_shots(B=96)
    cfg = {"osd_method": "osd_cs", "osd_order": 3, "max_iter": 10}
    t = T.BpOsdOverlappingWindowDecoder(dem, decoder_config=cfg, device="cpu", **kwargs)
    with pytest.warns(RuntimeWarning, match="per-window host loop"):
        assert t._maybe_device_scan() is None
    monkeypatch.setattr(josd_module, "jnp", _ZeroTimesInfIsZero())
    j = J.BpOsdOverlappingWindowDecoder(dem, decoder_config=cfg, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cj = j._corr_multiple_rounds_batch(shots.copy())
    ct = t._corr_multiple_rounds_batch(shots.copy())
    H = mats.check_matrix.toarray().astype(np.int64)
    weight = np.log(1.0 / mats.priors)
    ties = np.flatnonzero((cj != ct).any(axis=1))
    assert ties.size <= 2, ties
    for r in ties:
        assert np.array_equal(H @ cj[r] % 2, H @ ct[r] % 2)
        assert np.isclose(weight[cj[r] == 1].sum(), weight[ct[r] == 1].sum(), rtol=1e-12)


@pytest.mark.parametrize("method,order", [("osd_cs", 20), ("osd_e", 8)])
def test_owd_higher_order_windows_keep_every_column(monkeypatch, method, order):
    """OSD-CS and OSD-E windows at orders whose flip patterns reach past the
    non-empty columns below the prior keep every column of the DEM: each
    loop window's decoder takes all of them and none counts as narrowed.
    (On its own columns such a window can return a solution of lower
    weight than on every column: the patterns draw on the least reliable
    non-pivot columns, and the empty ones, at their prior, take some of
    those places.) Each window's decoding of the syndromes it was given
    equals the JAX package's decoder of that window, built with the same
    weights, on every lane but OSD-w ties: another solution of the same
    weight for the same syndrome (JAX's OSD-w weights summed over set bits,
    as in ``test_owd_higher_order_keeps_host_loop_and_warns``)."""
    import ldpc_tpu.ops.osd as josd_module
    from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder

    dem, m = surface_memory_dem(p=0.02, q=0.02)
    mats = T.detector_error_model_to_check_matrices(dem, allow_undecomposed_hyperedges=True)
    H = mats.check_matrix.toarray().astype(np.uint8)
    rng = np.random.default_rng(5)
    errs = (rng.random((256, H.shape[1])) < mats.priors).astype(np.uint8)
    shots = (errs @ H.T % 2).astype(np.uint8)
    kwargs = dict(decodings=5, window=4, commit=2, num_checks=m)
    cfg = {"osd_method": method, "osd_order": order, "max_iter": 10}
    given = {}
    decode_batch = BpOsdDecoder._decode_batch_device

    def record(self, syndromes):
        out = decode_batch(self, syndromes)
        given[id(self)] = (syndromes.cpu().numpy().copy(), out.cpu().numpy().copy())
        return out

    monkeypatch.setattr(BpOsdDecoder, "_decode_batch_device", record)
    monkeypatch.setattr(josd_module, "jnp", _ZeroTimesInfIsZero())
    t = T.BpOsdOverlappingWindowDecoder(dem, decoder_config=cfg, device="cpu", **kwargs)
    j = J.BpOsdOverlappingWindowDecoder(dem, decoder_config=cfg, **kwargs)
    pf.drain()
    pf.record(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the host loop's warning
            t._corr_multiple_rounds_batch(shots.copy())
    finally:
        pf.record(False)
    counters = pf.drain().counters
    assert counters["owd.windows.host"] == kwargs["decodings"]
    assert "owd.windows.narrowed" not in counters
    weights = mats.priors.copy()
    for k in range(kwargs["decodings"]):
        plan, td = t._plan(k), t._decoders[k]
        assert plan.cols == slice(0, H.shape[1]) and td.n == H.shape[1]
        syndromes, ct = given[id(td)]
        cj = np.asarray(j._init_decoder(plan.round_dcm, weights.copy()).decode_batch(syndromes))
        rows = plan.round_dcm.toarray().astype(np.int64)
        with np.errstate(divide="ignore"):
            cost = np.log(1.0 / weights)
        for r in np.flatnonzero((cj != ct).any(axis=1)):
            assert np.array_equal(rows @ cj[r] % 2, syndromes[r])
            assert np.array_equal(rows @ ct[r] % 2, syndromes[r])
            assert np.isclose(cost[cj[r] == 1].sum(), cost[ct[r] == 1].sum(), rtol=1e-12)
        weights[plan.commit_inds] = 0.0


def test_boundary_decoder_is_built_once():
    """A boundary window's decoder is built on the first call, with that
    call's weights, and reused."""
    dem, kwargs, shots, _, _ = _surface_shots(B=16)
    t = T.BpOsdOverlappingWindowDecoder(dem, device="cpu", **kwargs)
    t.decode_batch(shots)
    first = dict(t._decoders)
    assert sorted(first) == [0, 4]
    t.decode_batch(shots[:3])
    assert all(t._decoders[k] is first[k] for k in first)
    assert first[0].device == torch.device("cpu")


@pytest.mark.parametrize("post", ["osd0", "lsd0"])
def test_make_device_owd_matches_jax_scan(post):
    """The device windows alone, on the same pristine shots and the same
    running correction (random, to exercise the look-back adjustment)."""
    dem, kwargs, shots, _, mats = _surface_shots(B=128)
    uw = tscan.analyze_uniform_windows(mats.check_matrix, kwargs["decodings"], kwargs["window"],
                                       kwargs["commit"], kwargs["num_checks"], mats.priors)
    rng = np.random.default_rng(11)
    total = (rng.random((shots.shape[0], uw.num_cols)) < 0.02).astype(np.uint8)
    jfn = jscan.make_device_owd(uw, 0.0, max_iter=20, ms_scaling_factor=1.0, postprocess=post)
    tfn = tscan.make_device_owd(uw, 0.0, max_iter=20, ms_scaling_factor=1.0, postprocess=post,
                                device="cpu")
    pf.drain()
    pf.record(True)
    try:
        out = tfn(torch.from_numpy(shots), torch.from_numpy(total))
    finally:
        pf.record(False)
    assert pf.drain().counters["sync.owd_select"] == uw.w_hi - uw.w_lo  # one a window
    assert out.dtype == torch.uint8 and out.device == torch.device("cpu")
    ref = np.asarray(jfn(jnp.asarray(shots), jnp.asarray(total)))
    assert np.array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="unsupported postprocess"):
        tscan.make_device_owd(uw, 0.0, postprocess="osd_cs", device="cpu")


def test_lookback_adjustment_is_exact():
    """The integer look-back product equals H_win[:, :lookback] @ x mod 2."""
    dem, kwargs, _, _, mats = _surface_shots(B=1)
    uw = tscan.analyze_uniform_windows(mats.check_matrix, 5, 4, 2, kwargs["num_checks"],
                                       mats.priors)
    assert uw.lookback > 0
    table = tscan.lookback_rows(uw.H_win, uw.lookback)
    x = (np.random.default_rng(2).random((64, uw.lookback)) < 0.5).astype(np.uint8)
    xp = np.pad(x, ((0, 0), (0, 1)))
    got = xp[:, table].sum(axis=2) % 2
    want = (x.astype(np.int64) @ uw.H_win[:, : uw.lookback].T.astype(np.int64)) % 2
    assert np.array_equal(got, want)


def test_window_bp_and_osd_with_infinite_priors_match_jax(monkeypatch):
    """The scanned windows give K1' +inf priors on the committed look-back
    columns. The plain version makes no NaN and equals JAX's fast engine at
    alpha 1.0 (posteriors, infinities included); OSD-0's column order, with
    its ties at +inf, equals JAX's stable argsort, and its decodings JAX's."""
    dem, kwargs, shots, _, mats = _surface_shots(B=256, seed=8)
    t = T.BpOsdOverlappingWindowDecoder(dem, device="cpu", **kwargs)
    uw = t._maybe_device_scan()[0]
    seen = []
    original = twindow._postprocess

    def record(post, syn, bp, **kwargs):
        seen.append((syn.clone(), bp))
        return original(post, syn, bp, **kwargs)

    monkeypatch.setattr(twindow, "_postprocess", record)
    t.decode_batch(shots)
    assert len(seen) == uw.w_hi - uw.w_lo
    probs = uw.weights_win.copy()
    probs[: uw.lookback] = 0.0
    llr = jbp.channel_llr(probs, dtype=np.float32)
    assert np.isposinf(llr).sum() == uw.lookback > 0
    graph = compile_pcm(csr_matrix(uw.H_win))
    jfn = jbp.make_parallel_decoder(graph, jbp.MINIMUM_SUM, 30, 1.0)
    josd0 = josd.make_osd_decoder(graph, probs, josd.OSD_0, 0)
    tosd0 = tosd.make_osd_decoder(graph, probs, tosd.OSD_0, 0, "cpu")
    unconverged = 0
    for syn, bp in seen:
        ref = jfn(jnp.asarray(syn.numpy()), jnp.asarray(llr))
        post = bp.llr_posterior.numpy()
        assert not np.isnan(post).any() and np.isposinf(post).any()
        assert np.array_equal(post, np.asarray(ref.llr_posterior))
        assert np.array_equal(bp.decoding.numpy(), np.asarray(ref.decoding))
        assert np.array_equal(bp.converged.numpy(), np.asarray(ref.converged))
        assert np.array_equal(bp.iterations.numpy(), np.asarray(ref.iterations))
        idx = np.flatnonzero(~bp.converged.numpy())
        unconverged += idx.size
        if not idx.size:
            continue
        keys = bp.llr_posterior[idx]
        assert (torch.isposinf(keys).sum(dim=1) > 1).all()  # ties at +inf
        order = tgf2.column_order(keys).numpy()
        assert np.array_equal(order, np.asarray(jnp.argsort(jnp.asarray(keys.numpy()), axis=1,
                                                            stable=True)))
        x_ref = np.asarray(josd0(jnp.asarray(syn[idx].numpy()), jnp.asarray(keys.numpy()))[0])
        assert np.array_equal(tosd0(syn[idx], keys)[0].numpy(), x_ref)
    assert unconverged > 0


def test_boundary_windows_take_infinite_priors_without_nan(monkeypatch):
    """The boundary windows' decoders take their own columns, the span their
    rows touch, and the last window's sees +inf priors on every committed
    column of that span (the look-back its first rows reach). Their
    stored BP results (full depth) hold no NaN and equal, on every lane,
    the JAX package's fast engine run at full depth on the syndromes each
    decoder was given: decisions, flags, iterations and posteriors. (The
    JAX package's own ``BpOsdDecoder`` keeps the 6-iteration results of the
    lanes the cascade's first phase leaves unconverged in
    ``bp_decoding_batch`` and ``log_prob_ratios_batch``: here window 0's
    lane 175, converged at iteration 7, has bit 102 at 0.0 there and
    4.59512 at full depth; ROADMAP queue 3.)"""
    from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder

    dem, kwargs, shots, _, _ = _surface_shots(B=256, seed=8)
    j = J.BpOsdOverlappingWindowDecoder(dem, **kwargs)
    t = T.BpOsdOverlappingWindowDecoder(dem, device="cpu", **kwargs)
    given = {}
    decode_batch = BpOsdDecoder._decode_batch_device

    def record(self, syndromes):
        given[id(self)] = syndromes.cpu().numpy().copy()
        return decode_batch(self, syndromes)

    monkeypatch.setattr(BpOsdDecoder, "_decode_batch_device", record)
    ct = t._corr_multiple_rounds_batch(shots.copy())
    assert np.array_equal(ct, j._corr_multiple_rounds_batch(shots.copy()))
    last = kwargs["decodings"] - 1
    cols, committed = t._plan(last).cols, t._plan(last - 1).commit_inds.stop
    assert np.isposinf(tbp.channel_llr(t._decoders[last]._channel)).sum() == (
        committed - cols.start) > 0
    for k in (0, last):
        td = t._decoders[k]
        assert td.pcm.shape[1] == t._plan(k).cols.stop - t._plan(k).cols.start < t.dcm.shape[1]
        ref = jbp.make_parallel_decoder(compile_pcm(td.pcm), jbp.MINIMUM_SUM, 30, 1.0)(
            jnp.asarray(given[id(td)]), jnp.asarray(jbp.channel_llr(td._channel)))
        post = td.log_prob_ratios_batch
        assert not np.isnan(post).any() and np.isposinf(post).any() == (k == last)
        assert np.array_equal(td.converge_batch, np.asarray(ref.converged))
        assert 0.5 < td.converge_batch.mean() < 1.0
        assert np.array_equal(td.iter_batch, np.asarray(ref.iterations))
        assert np.array_equal(td.bp_decoding_batch, np.asarray(ref.decoding))
        assert np.array_equal(post, np.asarray(ref.llr_posterior))


def test_weight_one_mechanisms_and_batch_against_single():
    """tests/test_ckt_noise.py's checks on the port: every weight-1
    mechanism predicts its own observables (host loop, two windows; and the
    device windows on the 14-round DEM), and a batch equals its shots
    decoded one at a time."""
    for cls in (T.BpOsdOverlappingWindowDecoder, T.LsdOverlappingWindowDecoder):
        for dem, kw in (
            (rep_code_memory_dem(n_checks=2, rounds=6), dict(decodings=2, num_checks=2)),
            (rep_code_memory_dem(n_checks=3, rounds=14), dict(decodings=6, num_checks=3)),
        ):
            dec = cls(dem, window=4, commit=2, decoder_config={"max_iter": 20}, device="cpu",
                      **kw)
            if kw["decodings"] == 6:
                assert dec._maybe_device_scan() is not None
            m = T.detector_error_model_to_check_matrices(dem, allow_undecomposed_hyperedges=True)
            Hd = np.asarray(m.check_matrix.todense(), np.uint8)
            Od = np.asarray(m.observables_matrix.todense(), np.uint8)
            eye = np.eye(Hd.shape[1], dtype=np.uint8)
            preds = np.stack([dec.decode((Hd @ e) % 2) for e in eye])
            assert np.array_equal(preds % 2, (eye @ Od.T) % 2)
            rng = np.random.default_rng(3)
            errs = (rng.random((16, Hd.shape[1])) < 0.05).astype(np.uint8)
            shots = ((errs @ Hd.T) % 2).astype(np.uint8)
            batch = dec.decode_batch(shots)
            single = np.stack([dec.decode(s) for s in shots])
            assert np.array_equal(batch.astype(int) % 2, single % 2)


def test_owd_validation_matches_jax():
    dem = rep_code_memory_dem(n_checks=2, rounds=6)
    with pytest.raises(ValueError, match="multiple"):
        T.BpOsdOverlappingWindowDecoder(dem, decodings=2, window=4, commit=3, num_checks=2,
                                        device="cpu")
    dec = T.BpOsdOverlappingWindowDecoder(dem, decodings=2, window=4, commit=2, num_checks=2,
                                          decoder_config={"max_iter": 10}, device="cpu")
    with pytest.warns(RuntimeWarning):
        assert dec._maybe_device_scan() is None  # too few windows


def test_pymatching_owd_weights_match_jax():
    """The matching decoder's edge weights and committed weight equal the
    JAX package's; pymatching itself is imported only to decode."""
    dem, kwargs, shots, _, _ = _surface_shots(B=2)
    j = J.PyMatchingOverlappingWindowDecoder(dem, **kwargs)
    t = T.PyMatchingOverlappingWindowDecoder(dem, device="cpu", **kwargs)
    assert np.array_equal(t._get_weights(), j._get_weights())
    assert t._min_weight == j._min_weight
    _same_sparse(t.dcm, j.dcm)
    assert t._maybe_device_scan.__func__ is T.BaseOverlappingWindowDecoder._maybe_device_scan
    with pytest.raises(ImportError):
        t.decode_batch(shots)


class _MockSampler:
    def __init__(self, dets, obs):
        self._dets, self._obs = dets, obs

    def sample(self, num_shots, separate_observables):
        assert separate_observables
        return self._dets[:num_shots], self._obs[:num_shots]


class MockCircuit:
    """The two calls ``count_logical_errors`` makes of a stim circuit."""

    def __init__(self, dem, dets, obs):
        self._dem, self._dets, self._obs = dem, dets, obs

    def compile_detector_sampler(self):
        return _MockSampler(self._dets, self._obs)

    def detector_error_model(self, decompose_errors):
        assert decompose_errors
        return self._dem


def mock_circuit(B=128, seed=4):
    dem, _ = surface_memory_dem(d=3, rounds=4, p=0.02, q=0.02)
    mats = T.detector_error_model_to_check_matrices(dem)
    rng = np.random.default_rng(seed)
    errs = (rng.random((B, mats.check_matrix.shape[1])) < mats.priors).astype(np.uint8)
    dets = (errs @ mats.check_matrix.T.toarray() % 2).astype(bool)
    obs = (errs @ mats.observables_matrix.T.toarray() % 2).astype(bool)
    return MockCircuit(dem, dets, obs)


def test_count_logical_errors_matches_jax():
    from ldpc_tpu.ckt_noise import not_an_arb_ckt_simulator as jsim
    from ldpc_tpu_torch.ckt_noise import not_an_arb_ckt_simulator as tsim

    circuit = mock_circuit()
    count = tsim.count_logical_errors(circuit, 128, device="cpu")
    assert count == jsim.count_logical_errors(circuit, 128)
    assert 0 < count < 64


@pytest.mark.parametrize("cls", ["SinterDecoder_BPOSD_OWD", "SinterDecoder_LSD_OWD"])
def test_sinter_owd_adapter_matches_jax(cls):
    """The overlapping-window adapters (the device windows of the 14-round
    rep-code DEM), packed detection events in, packed predictions out."""
    dem = rep_code_memory_dem(n_checks=3, rounds=14)
    mats = T.detector_error_model_to_check_matrices(dem)
    Hd = mats.check_matrix.toarray()
    rng = np.random.default_rng(4)
    errs = (rng.random((64, Hd.shape[1])) < 0.03).astype(np.uint8)
    shots = (errs @ Hd.T % 2).astype(np.uint8)
    packed = np.packbits(shots, axis=1, bitorder="little")
    kw = dict(decodings=6, window=4, commit=2, num_checks=3, decoder_config={"max_iter": 20})
    t = getattr(TOWD, cls)(device="cpu", **kw).compile_decoder_for_dem(dem=dem)
    j = getattr(JOWD, cls)(**kw).compile_decoder_for_dem(dem=dem)
    assert t.decoder._maybe_device_scan() is not None
    out = t.decode_shots_bit_packed(bit_packed_detection_event_data=packed)
    assert np.array_equal(out, j.decode_shots_bit_packed(bit_packed_detection_event_data=packed))
