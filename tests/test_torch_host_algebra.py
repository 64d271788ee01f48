"""The port's host modules against the JAX package's originals:
the GF(2) toolbox ``mod2`` (its numpy path), ``code_util``, ``alist`` and
``protograph``, on rep, hamming, surface d=5 and seeded random matrices;
and the port's batched noise samplers, held statistically (their
``torch.Generator`` gives other numbers than ``jax.random``).

``estimate_code_distance`` is a randomized search: it is held by bounds
(never below the exact distance, equal to it on small codes), as the two
packages' searches draw different samples.
"""

import os

import numpy as np
import pytest
import scipy.sparse
import torch

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu import alist as jalist
from ldpc_tpu import code_util as jcu
from ldpc_tpu import mod2 as jmod2
from ldpc_tpu import protograph as jproto
from ldpc_tpu.codes import hamming_code, rep_code, ring_code, surface_code
from ldpc_tpu.mod2 import mod2_numpy as jnp2
from ldpc_tpu_torch import alist as talist
from ldpc_tpu_torch import code_util as tcu
from ldpc_tpu_torch import mod2 as tmod2
from ldpc_tpu_torch import noise_models as tnoise
from ldpc_tpu_torch import protograph as tproto
from ldpc_tpu_torch.mod2 import mod2_numpy as tnp2


def _random(seed, m, n, p=0.3):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(np.uint8)


MATRICES = {
    "rep5": lambda: rep_code(5),
    "hamming3": lambda: hamming_code(3),
    "hamming4": lambda: hamming_code(4),
    "surface5": lambda: surface_code(5).hx,
    "random_12x20": lambda: _random(1, 12, 20),
    "random_20x12": lambda: _random(2, 20, 12),
    "random_dense_9x9": lambda: _random(3, 9, 9, 0.5),
    "random_sparse_30x40": lambda: scipy.sparse.csr_matrix(_random(4, 30, 40, 0.1)),
}


def _dense(x):
    return x.toarray() if scipy.sparse.issparse(x) else np.asarray(x)


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif scipy.sparse.issparse(a) or isinstance(a, np.ndarray):
        np.testing.assert_array_equal(_dense(a), _dense(b))
    else:
        assert a == b


@pytest.mark.parametrize("name", list(MATRICES))
def test_mod2_matches_jax(name):
    """Every function of the toolbox equals the JAX package's on the same
    matrix (both packages pivot on the first unused row of each column)."""
    H = MATRICES[name]()
    for method in ("dense", "sparse"):
        assert tmod2.rank(H, method=method) == jmod2.rank(H, method=method)
    for fn in ("kernel", "nullspace", "row_complement_basis", "pivot_rows", "row_basis",
               "io_test", "reduced_row_echelon"):
        _equal(getattr(tmod2, fn)(H), getattr(jmod2, fn)(H))
    for full in (False, True):
        _equal(tmod2.row_echelon(H, full=full), jmod2.row_echelon(H, full=full))
    ech, rk, transform, _ = tmod2.row_echelon(H, full=True)
    np.testing.assert_array_equal(transform @ _dense(H) % 2, ech)
    rre, _, rows, cols = tmod2.reduced_row_echelon(H)
    np.testing.assert_array_equal(rows @ _dense(H) @ cols % 2, rre)
    if _dense(H).shape[0] <= 12:
        _equal(tmod2.row_span(H), jmod2.row_span(H))
    if _dense(H).shape[1] <= 20:
        assert tmod2.compute_exact_code_distance(H) == jmod2.compute_exact_code_distance(H)


@pytest.mark.parametrize("full_reduce", [False, True])
@pytest.mark.parametrize("name", list(MATRICES))
def test_plu_decomposition_matches_jax(name, full_reduce):
    H = MATRICES[name]()
    t, j = tmod2.PluDecomposition(H, full_reduce), jmod2.PluDecomposition(H, full_reduce)
    assert t.rank == j.rank
    for attr in ("pivots", "L", "U", "P"):
        _equal(getattr(t, attr), getattr(j, attr))
    if not full_reduce:
        np.testing.assert_array_equal(_dense(t.P) @ _dense(t.L) @ _dense(t.U) % 2, _dense(H))
    x = (np.random.default_rng(5).random(_dense(H).shape[1]) < 0.5).astype(np.uint8)
    y = _dense(H) @ x % 2
    sol = t.lu_solve(y)
    np.testing.assert_array_equal(sol, j.lu_solve(y))
    if not full_reduce:  # the fully reduced U no longer factors H
        np.testing.assert_array_equal(_dense(H) @ sol % 2, y)
    with pytest.raises(ValueError):
        t.lu_solve(np.zeros(_dense(H).shape[0] + 1))


def test_inverse_and_errors_match_jax():
    rng = np.random.default_rng(9)
    done = 0
    while done < 3:
        A = (rng.random((8, 8)) < 0.5).astype(np.uint8)
        if jmod2.rank(A) < 8:
            with pytest.raises(ValueError, match="invertible"):
                tmod2.inverse(A)
            continue
        inv = tmod2.inverse(A)
        np.testing.assert_array_equal(inv, jmod2.inverse(A))
        np.testing.assert_array_equal(inv @ A % 2, np.eye(8, dtype=np.uint8))
        done += 1
    with pytest.raises(TypeError, match="invalid type"):
        tmod2.rank([[1, 0]])
    with pytest.raises(ValueError, match="Invalid method"):
        tmod2.rank(np.eye(2, dtype=np.uint8), method="bogus")
    with pytest.raises(ValueError, match="not invertible"):
        tmod2.inverse(np.ones((2, 3), np.uint8))


def test_mod2_numpy_names_match_jax():
    H = _random(6, 6, 10)
    assert tnp2.mod10_to_mod2(2, length=5) == jnp2.mod10_to_mod2(2, length=5) == [0, 0, 0, 1, 0]
    assert tnp2.mod2_to_mod10(np.array([0, 0, 0, 1, 0])) == 2
    for fn in ("rank", "nullspace", "row_span", "row_basis", "reduced_row_echelon"):
        _equal(getattr(tnp2, fn)(H), getattr(jnp2, fn)(H))
    _equal(tnp2.row_echelon(H, full=True), jnp2.row_echelon(H, full=True))
    A = np.array([[1, 1, 0], [0, 1, 0], [0, 1, 1]], np.uint8)
    np.testing.assert_array_equal(tnp2.inverse(A), jnp2.inverse(A))
    assert tmod2.mod10_to_mod2 is tnp2.mod10_to_mod2
    assert sorted(tmod2.__all__) == sorted(jmod2.__all__)


@pytest.mark.parametrize("name,d", [("rep5", 5), ("hamming3", 3), ("ring7", 7)])
def test_estimate_code_distance_bounds(name, d):
    """The randomized estimate never undercuts the exact distance and finds
    it on small codes; its saved words are codewords of that weight or
    more, lightest first."""
    H = {"rep5": rep_code(5), "hamming3": hamming_code(3), "ring7": ring_code(7)}[name]
    assert tmod2.compute_exact_code_distance(H) == d
    est, samples, words = tmod2.estimate_code_distance(H, timeout_seconds=0.05)
    assert est == d and samples > 0
    W = words.toarray()
    W = W[W.any(axis=1)]
    assert (W @ _dense(H).T % 2 == 0).all()
    assert (W.sum(axis=1) >= d).all() and W.sum(axis=1)[0] == d
    j_est = jmod2.estimate_code_distance(H, timeout_seconds=0.05)[0]
    assert j_est == est


@pytest.mark.parametrize("name", ["hamming4", "random_12x20", "surface5"])
def test_estimate_code_distance_never_undercuts(name):
    """On larger kernels the estimate is at least the exact distance (where
    the exhaustive search is cheap) and names a codeword of its weight."""
    H = MATRICES[name]()
    est, _, words = tmod2.estimate_code_distance(H, timeout_seconds=0.05)
    if _dense(H).shape[1] - tmod2.rank(H) <= 12:
        assert est >= tmod2.compute_exact_code_distance(H)
    w = words.toarray()[0]
    assert w.sum() == est and not (_dense(H) @ w % 2).any()


def test_estimate_code_distance_trivial_kernel():
    full = np.eye(4, dtype=np.uint8)
    est, samples, words = tmod2.estimate_code_distance(full)
    assert est == np.iinfo(np.int32).max and samples == 0 and words.shape == (10, 4)
    assert tmod2.compute_exact_code_distance(full) == -1


@pytest.mark.parametrize("name", ["rep5", "hamming3", "random_12x20", "random_20x12"])
def test_code_util_matches_jax(name):
    H = MATRICES[name]()
    _equal(tcu.construct_generator_matrix(H), jcu.construct_generator_matrix(H))
    assert tcu.compute_code_dimension(H) == jcu.compute_code_dimension(H)
    n, k, d = tcu.compute_code_parameters(H, timeout_seconds=0.02)
    jn, jk, _ = jcu.compute_code_parameters(H, timeout_seconds=0.02)
    assert (n, k) == (jn, jk)
    if k:
        exact = jcu.compute_exact_code_distance(H)
        assert tcu.compute_exact_code_distance(H) == exact
        assert tcu.compute_code_distance(H) == exact
        assert d >= exact
    Hd = _dense(H)
    assert tcu.compute_avg_hamming_weights(Hd) == jcu.compute_avg_hamming_weights(Hd)
    for girth in (4, 6):
        assert tcu.search_cycles(H, girth) == jcu.search_cycles(H, girth)
        assert tcu.search_cycles(H, girth, terminate=False) == jcu.search_cycles(
            H, girth, terminate=False)
        assert tcu.search_cycles(H, girth, row=1, terminate=False) == jcu.search_cycles(
            H, girth, row=1, terminate=False)


def test_code_util_errors_and_exports_match_jax():
    with pytest.raises(ValueError, match="dimension zero"):
        tcu.compute_exact_code_distance(np.eye(3, dtype=np.uint8))
    with pytest.warns(UserWarning, match="exponential"):
        tcu.compute_exact_code_distance(rep_code(16))
    assert sorted(tcu.__all__) == sorted(jcu.__all__)


@pytest.mark.parametrize("name", ["hamming3", "surface5", "random_12x20"])
def test_alist_matches_jax(tmp_path, name):
    """The two packages write the same alist file and read each other's."""
    H = _dense(MATRICES[name]()).astype(np.int64)
    pt, pj = os.path.join(tmp_path, "t.alist"), os.path.join(tmp_path, "j.alist")
    talist.save_alist(pt, H)
    jalist.save_alist(pj, H)
    assert open(pt).read() == open(pj).read()
    np.testing.assert_array_equal(talist.alist2numpy(pj), H)
    np.testing.assert_array_equal(jalist.alist2numpy(pt), H)
    talist.numpy2alist(pt, H, j=9, k=9)
    jalist.numpy2alist(pj, H, j=9, k=9)
    assert open(pt).read() == open(pj).read()


def test_protograph_matches_jax():
    for mod in (tproto, jproto):
        a = mod.RingOfCirculantsF2([1, 2])
        b = mod.RingOfCirculantsF2([0, 1])
        assert (a + a).len() == 0
        assert sorted((a * b).coefficients) == [1, 3]
        assert a.T == mod.RingOfCirculantsF2([-1, -2])
        assert 2 * a == mod.RingOfCirculantsF2([]) and 3 * a == a
    spec = [[(0,), (1, 2)], [(), (0, 1)], [(3,), (0,)]]
    t, j = tproto.array(spec), jproto.array(spec)
    for lift in (3, 5):
        np.testing.assert_array_equal(t.to_binary(lift), j.to_binary(lift))
        np.testing.assert_array_equal(t.T.to_binary(lift), j.T.to_binary(lift))
    np.testing.assert_array_equal(tproto.permutation_matrix(5, 2), jproto.permutation_matrix(5, 2))
    np.testing.assert_array_equal(tproto.identity(2).to_binary(4), jproto.identity(2).to_binary(4))
    np.testing.assert_array_equal(
        tproto.vstack([t, tproto.zeros((1, 2))]).to_binary(3),
        jproto.vstack([j, jproto.zeros((1, 2))]).to_binary(3))
    np.testing.assert_array_equal(tproto.hstack([t, t]).to_binary(2),
                                  jproto.hstack([j, j]).to_binary(2))
    assert str(t) == str(j)


def test_lazy_exports_match_jax():
    for name in ("alist", "code_util", "noise_models", "protograph", "mod2", "helpers"):
        assert getattr(ldpc_tpu_torch, name).__name__ == f"ldpc_tpu_torch.{name}"
    assert ldpc_tpu_torch.MbpDecoder is ldpc_tpu_torch.mbp_decoder
    assert {"MbpDecoder", "mbp_decoder", "mod2", "alist", "code_util", "noise_models",
            "protograph"} <= set(ldpc_tpu_torch.__all__)
    assert ldpc_tpu.mbp_decoder is not None
    with pytest.raises(AttributeError):
        ldpc_tpu_torch.no_such_module  # noqa: B018


# ---- noise samplers ------------------------------------------------------------------


def test_generate_bsc_error():
    np.random.seed(0)
    e = tnoise.generate_bsc_error(1000, 0.1)
    assert e.shape == (1000,) and e.dtype == np.uint8
    assert 50 < e.sum() < 200


@pytest.mark.parametrize("p", [0.01, 0.1, 0.3])
def test_bsc_batch_rate(p):
    """The rate within 5 sigma over 200,000 draws, uint8 on the device."""
    gen = torch.Generator().manual_seed(3)
    e = tnoise.generate_bsc_error_batch(gen, 400, 500, p, device="cpu")
    assert e.shape == (400, 500) and e.dtype == torch.uint8 and e.max() <= 1
    N = e.numel()
    assert abs(float(e.float().mean()) - p) < 5 * np.sqrt(p * (1 - p) / N)


@pytest.mark.parametrize("p", [0.03, 0.3])
def test_depolarizing_batch_rates_and_independence(p):
    """Each of X, Y, Z at p/3 and the identity at 1 - p, within 5 sigma; and
    the Pauli kind independent of whether the qubit errs: the kinds the
    error-free qubits would have drawn are not seen, so independence shows
    as the kind's frequencies among the errors not depending on how low the
    uniform draw was (the two halves of the error rate), and as each Pauli
    appearing at every rate."""
    gen = torch.Generator().manual_seed(11)
    e = tnoise.generate_depolarizing_error_batch(gen, 500, 400, p, device="cpu").numpy()
    assert e.dtype == np.uint8 and e.max() <= 3
    N = e.size
    for k in (1, 2, 3):
        f = (e == k).mean()
        assert abs(f - p / 3) < 5 * np.sqrt(p / 3 * (1 - p / 3) / N)
    assert abs((e == 0).mean() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / N)
    # the same draws again, reproducing u: low half u < p/2 against high half
    gen = torch.Generator().manual_seed(11)
    u = torch.rand((500, 400), generator=gen).numpy()
    low, high = (u < p / 2), (u >= p / 2) & (u < p)
    for k in (1, 2, 3):
        a, b = (e[low] == k).mean(), (e[high] == k).mean()
        sigma = np.sqrt((1 / 3) * (2 / 3) * (1 / low.sum() + 1 / high.sum()))
        assert abs(a - b) < 5 * sigma


def test_depolarizing_kind_is_not_a_function_of_u():
    """JAX's sampler draws u and the kind from one key; the port's draws
    them apart. Two batches with the same u stream but a generator advanced
    between the draws must not give the same kinds."""
    gen = torch.Generator().manual_seed(5)
    e = tnoise.generate_depolarizing_error_batch(gen, 200, 200, 1.0, device="cpu").numpy()
    gen = torch.Generator().manual_seed(5)
    u = torch.rand((200, 200), generator=gen).numpy()
    # with p = 1 every qubit errs; the kind must not be a function of u's bucket
    for lo in (0.0, 1 / 3, 2 / 3):
        kinds = e[(u >= lo) & (u < lo + 1 / 3)]
        assert len(np.unique(kinds)) == 3
