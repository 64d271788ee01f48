"""The port's MBP over GF(4) (``ldpc_tpu_torch.ops.mbp``, ``MbpDecoder``)
against the JAX package's, on the same syndromes (made with numpy from a
seed), plus the JAX package's own MBP decoder probes.

Tolerance tier (float64, the decoder's default): decisions, convergence
flags and iteration counts equal on every lane; posteriors within rtol
1e-6, atol 1e-5 on the converged lanes. The plain version computes every
sum, product and quotient in the JAX loop's order, but JAX's (XLA's) and
torch's exp, log and tanh differ by ulps, and a product-sum lane carries
that difference through its iterations: on these inputs the largest gap
is 3.6e-7 (surface d=5, product-sum, alpha 0.65), min-sum's 1.7e-13
(``tools/jax_contraction_readings.py``). In float32 the same ulps move
decisions: up to 45 of 200 lanes part on these inputs (ROADMAP queue 3),
so ``tests/test_torch_mbp_f32.py`` holds float32 against JAX through JAX's
own exp, log and tanh.
"""

import functools

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, surface_code
from ldpc_tpu.ops import mbp as jmbp
from ldpc_tpu_torch.ops import mbp as tmbp

torch.set_num_threads(1)

MAX_ITER = 12
BATCH = 200


def steane_gf4():
    """The [[7,1,3]] Steane code as a GF(4) stabilizer matrix."""
    h = np.asarray(hamming_code(3).todense(), np.uint8)
    return np.vstack([h * 1, h * 3]).astype(np.uint8)  # X block, Z block


def surface_pair(d):
    code = surface_code(d)
    return (np.asarray(code.hx.todense(), np.uint8), np.asarray(code.hz.todense(), np.uint8))


def gf4_form(d):
    hx, hz = surface_pair(d)
    return np.vstack([hx * 1, hz * 3]).astype(np.uint8)


def css_form(d):
    hx, hz = surface_pair(d)
    return np.vstack([hz * 3, hx * 1]).astype(np.uint8)  # MbpDecoder's stacking


CODES = {
    "steane": steane_gf4,
    "surface3_gf4": lambda: gf4_form(3),
    "surface3_css": lambda: css_form(3),
    "surface5_gf4": lambda: gf4_form(5),
    "surface5_css": lambda: css_form(5),
}


@functools.lru_cache(maxsize=None)
def workload(name, p=0.08, seed=5):
    H = CODES[name]()
    n = H.shape[1]
    rng = np.random.default_rng(seed)
    e = np.where(rng.random((BATCH, n)) < p, rng.integers(1, 4, (BATCH, n)), 0).astype(np.uint8)
    syn = jmbp.pauli_syndrome(H, e).astype(np.uint8)
    syn[3] = 0  # a zero-syndrome row
    return H, syn


@pytest.mark.parametrize("name", list(CODES))
def test_compile_gf4_matches_jax(name):
    H = CODES[name]()
    j, t = jmbp.compile_gf4(H), tmbp.compile_gf4(scipy.sparse.csr_matrix(H))
    np.testing.assert_array_equal(t.chk_val, j.chk_val)
    np.testing.assert_array_equal(t.var_val, j.var_val)
    np.testing.assert_array_equal(t.graph.chk_bits, j.graph.chk_bits)
    np.testing.assert_array_equal(t.graph.var_chks, j.graph.var_chks)
    e = np.random.default_rng(1).integers(0, 4, (5, H.shape[1])).astype(np.uint8)
    np.testing.assert_array_equal(tmbp.pauli_syndrome(H, e), jmbp.pauli_syndrome(H, e))


def test_level_schedule_is_the_serial_sweep():
    """The plain version's levels: every qubit once, no two qubits of a
    level share a stabilizer, and a qubit's level is past every earlier
    qubit it shares one with."""
    H = css_form(5)
    g = tmbp.gf4_to_torch(tmbp.compile_gf4(H), "cpu")
    bits, ptr = g.lv_bits.numpy(), g.lv_ptr.numpy()
    assert sorted(bits.tolist()) == list(range(H.shape[1]))
    level = np.empty(H.shape[1], int)
    for lv in range(g.levels):
        q = bits[ptr[lv]:ptr[lv + 1]]
        level[q] = lv
        assert (((H[:, q] != 0).sum(axis=1)) <= 1).all()
        assert g.max_level >= len(q)
    for i in range(H.shape[0]):
        on = np.flatnonzero(H[i])
        assert (np.diff(level[on]) > 0).all()  # index order within a row


SETTINGS = [(method, alpha, beta) for method in (tmbp.PRODUCT_SUM, tmbp.MINIMUM_SUM)
            for alpha in (1.0, 0.65) for beta in (0.0, 0.5)]


@pytest.mark.parametrize("method,alpha,beta", SETTINGS)
@pytest.mark.parametrize("name", list(CODES))
def test_mbp_plain_matches_jax(name, method, alpha, beta):
    """The plain version against ``make_mbp_decoder`` in float64: the tier
    of the module docstring."""
    H, syn = workload(name)
    n = H.shape[1]
    channel = np.full((3, n), 0.08 / 3)
    alphas = np.full((3, n), alpha)
    jout = jmbp.make_mbp_decoder(jmbp.compile_gf4(H), channel, MAX_ITER, alphas, beta, method,
                                 0.625, dtype=jnp.float64)(jnp.asarray(syn))
    tout = tmbp.make_mbp_decoder(tmbp.compile_gf4(H), channel, MAX_ITER, alphas, beta, method,
                                 0.625, device="cpu")(syn)
    dj, lj, cj, ij = (np.asarray(x) for x in jout)
    dt, lt, ct, it = (x.numpy() for x in tout)
    assert dt.dtype == np.uint8 and lt.dtype == np.float64 and lt.shape == (BATCH, 3, n)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(it, ij)
    assert cj[3] and ij[3] == 1  # the zero syndrome converges at once
    np.testing.assert_allclose(lt[cj], lj[cj], rtol=1e-6, atol=1e-5)
    # a converged lane's decision reproduces its syndrome
    cand = tmbp.pauli_syndrome(H, dt[ct])
    np.testing.assert_array_equal(cand, syn[ct])


def test_mbp_plain_depth_zero_and_float32():
    """At depth 0 nothing runs (zero decisions and posteriors, no lane
    converged); float32 runs in float32."""
    H, syn = workload("steane")
    n = H.shape[1]
    g4 = tmbp.compile_gf4(H)
    dec, llr, conv, iters = tmbp.make_mbp_decoder(g4, np.full((3, n), 0.03), 0, np.ones((3, n)),
                                                  0.0, tmbp.PRODUCT_SUM, 1.0, device="cpu")(syn)
    assert not dec.any() and not llr.any() and not conv.any() and not iters.any()
    out = tmbp.make_mbp_decoder(g4, np.full((3, n), 0.03), 5, np.ones((3, n)), 0.0,
                                tmbp.MINIMUM_SUM, 1.0, device="cpu", dtype=torch.float32)(syn)
    assert out[1].dtype == torch.float32
    assert out[2][3] and out[3][3] == 1  # the zero syndrome converges at once


# ---- MbpDecoder against ldpc_tpu.MbpDecoder ----------------------------------------


def _pair(**kw):
    return (ldpc_tpu.MbpDecoder(**kw),
            ldpc_tpu_torch.MbpDecoder(**kw, device="cpu"))


def test_mbp_identity_alias():
    assert ldpc_tpu_torch.mbp_decoder is ldpc_tpu_torch.MbpDecoder
    import ldpc_tpu_torch.mbp_decoder as shim

    assert isinstance(shim(Hgf4=steane_gf4(), error_rate=0.1, device="cpu"),
                      ldpc_tpu_torch.MbpDecoder)


@pytest.mark.parametrize("bp_method", ["product_sum", "min_sum"])
def test_mbp_single_pauli_errors_steane(bp_method):
    """Every single-Pauli error of the Steane code, decoded one at a time:
    decisions, ``converge``, ``iter`` and posteriors as the JAX decoder's."""
    Hgf4 = steane_gf4()
    jd, td = _pair(Hgf4=Hgf4, error_rate=0.1, max_iter=30, alpha_parameter=0.65,
                   bp_method=bp_method, gamma_parameter=0.9)
    ok = 0
    for q in range(7):
        for p in (1, 2, 3):
            e = np.zeros(7, np.uint8)
            e[q] = p
            s = jmbp.pauli_syndrome(Hgf4, e[None, :])[0].astype(np.uint8)
            out_j, out_t = jd.decode(s), td.decode(s)
            np.testing.assert_array_equal(out_t, out_j)
            assert (td.converge, td.iter) == (jd.converge, jd.iter)
            np.testing.assert_allclose(td.log_prob_ratios, jd.log_prob_ratios, rtol=1e-6, atol=1e-5)
            np.testing.assert_array_equal(td.decoding, jd.decoding)
            if td.converge:
                cand = jmbp.pauli_syndrome(Hgf4, out_t[None, :].astype(np.uint8))[0]
                assert np.array_equal(cand, s)
                ok += 1
    assert ok >= 15


def test_mbp_zero_syndrome():
    td = ldpc_tpu_torch.MbpDecoder(Hgf4=steane_gf4(), error_rate=0.05, max_iter=10, device="cpu")
    out = td.decode(np.zeros(6, np.uint8))
    assert not out.any()
    assert td.converge


@pytest.mark.parametrize("d", [3, 5])
def test_mbp_css_decode_batch_matches_jax(d):
    """CSS input ([3 hz; hx] stacking): ``decode_batch`` on 200 depolarizing
    syndromes, and ``decode(sx=, sz=)`` returning the (x, z) pair."""
    hx, hz = surface_pair(d)
    jd, td = _pair(HX_CSS=hx, HZ_CSS=hz, error_rate=0.08, max_iter=MAX_ITER,
                   alpha_parameter=0.65)
    _, syn = workload(f"surface{d}_css")
    np.testing.assert_array_equal(td.decode_batch(syn), jd.decode_batch(syn))
    np.testing.assert_array_equal(td.converge_batch, jd.converge_batch)
    np.testing.assert_array_equal(td.iter_batch, jd.iter_batch)
    e = np.zeros(hx.shape[1], np.uint8)
    e[0] = 1
    sx, sz = (hz @ e % 2).astype(np.uint8), np.zeros(hx.shape[0], np.uint8)
    for a, b in zip(td.decode(sx=sx, sz=sz), jd.decode(sx=sx, sz=sz)):
        np.testing.assert_array_equal(a, b)
    assert td.output_type == "css" and td.stab_count == hx.shape[0] + hz.shape[0]


def test_mbp_uf_decode_matches_jax():
    """``uf_decode`` on CSS syndromes: MBP, then, where it does not
    converge, union-find (matrix mode) weighted from the MBP posteriors,
    as the JAX decoder does."""
    hx, hz = surface_pair(5)
    jd, td = _pair(HX_CSS=hx, HZ_CSS=hz, error_rate=0.05, max_iter=8, bp_method="ms",
                   gamma_parameter=0.625)
    rng = np.random.default_rng(11)
    n = hx.shape[1]
    fell_back = 0
    for _ in range(12):
        ex, ez = ((rng.random(n) < 0.1).astype(np.uint8) for _ in range(2))
        sx, sz = (hz @ ex % 2).astype(np.uint8), (hx @ ez % 2).astype(np.uint8)
        with np.errstate(all="ignore"):
            a, b = td.uf_decode(sx=sx, sz=sz), jd.uf_decode(sx=sx, sz=sz)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        fell_back += not td.converge
    assert fell_back  # the union-find fallback ran
    with pytest.raises(ValueError, match="CSS"):
        ldpc_tpu_torch.MbpDecoder(Hgf4=steane_gf4(), error_rate=0.1, device="cpu").uf_decode(
            sx=np.zeros(3), sz=np.zeros(3))


def test_mbp_validation():
    D = functools.partial(ldpc_tpu_torch.MbpDecoder, device="cpu")
    with pytest.raises(ValueError, match="GF4 parity check"):
        D(error_rate=0.1)
    with pytest.raises(ValueError, match="columns"):
        D(HX_CSS=np.eye(3, 4, dtype=np.uint8), HZ_CSS=np.eye(3, 5, dtype=np.uint8),
          error_rate=0.1)
    with pytest.raises(ValueError, match="BP method"):
        D(Hgf4=steane_gf4(), error_rate=0.1, bp_method="bogus")
    with pytest.raises(ValueError, match="error_rate or error_channel"):
        D(Hgf4=steane_gf4())
    with pytest.raises(ValueError, match="shape"):
        D(Hgf4=steane_gf4(), error_channel=np.full((3, 6), 0.03))
    with pytest.warns(UserWarning):
        D(Hgf4=steane_gf4(), error_rate=0.1, error_channel=np.full((3, 7), 0.03))
    dec = D(Hgf4=steane_gf4(), error_rate=0.1)
    with pytest.raises(ValueError, match="length 6"):
        dec.decode(np.zeros(5, np.uint8))
    with pytest.raises(ValueError, match="Invalid syndrome"):
        dec.decode()


def test_mbp_channel_and_properties_match_jax():
    """``xyz_bias`` splits ``error_rate``; ``max_iter=0`` means n; the
    properties as the JAX decoder's."""
    jd, td = _pair(Hgf4=steane_gf4(), error_rate=0.09, xyz_bias=[1, 2, 0], max_iter=0,
                   alpha_parameter=[0.5, 0.75, 1.0], beta_parameter=0.25, bp_method=1,
                   gamma_parameter=0.8)
    np.testing.assert_array_equal(td.error_channel, jd.error_channel)
    np.testing.assert_array_equal(td.alpha, jd.alpha)
    np.testing.assert_array_equal(td.xyz_bias, jd.xyz_bias)
    assert (td.max_iter, td.bp_method, td.beta_parameter, td.gamma_parameter) == (
        jd.max_iter, jd.bp_method, jd.beta_parameter, jd.gamma_parameter) == (7, 1, 0.25, 0.8)
    s = np.array([1, 0, 1, 0, 0, 1], np.uint8)
    np.testing.assert_array_equal(td.decode(s), jd.decode(s))
    assert (td.iter, td.converge) == (jd.iter, jd.converge)
    assert td.device == torch.device("cpu")


def test_mbp_min_sum_runs():
    Hgf4 = steane_gf4()
    jd, td = _pair(Hgf4=Hgf4, error_rate=0.1, max_iter=30, bp_method="min_sum",
                   alpha_parameter=0.65, gamma_parameter=0.9)
    e = np.zeros(7, np.uint8)
    e[2] = 1
    s = jmbp.pauli_syndrome(Hgf4, e[None, :])[0].astype(np.uint8)
    out = td.decode(s)
    np.testing.assert_array_equal(out, jd.decode(s))
    if td.converge:
        cand = jmbp.pauli_syndrome(Hgf4, out[None, :].astype(np.uint8))[0]
        assert np.array_equal(cand, s)


def test_mbp_batch_matches_single():
    Hgf4 = steane_gf4()
    dec = ldpc_tpu_torch.MbpDecoder(Hgf4=Hgf4, error_rate=0.1, max_iter=20,
                                    alpha_parameter=0.65, device="cpu")
    errs = np.zeros((4, 7), np.uint8)
    errs[0, 1] = 1
    errs[1, 3] = 3
    errs[2, 5] = 2
    syn = jmbp.pauli_syndrome(Hgf4, errs).astype(np.uint8)
    batch = dec.decode_batch(syn)
    for i in range(4):
        single = dec.decode_batch(syn[i : i + 1])[0]
        assert np.array_equal(single, batch[i])


def test_mbp_update_alpha():
    """As ``tests/test_api_parity.py::test_mbp_update_alpha``, and the
    rebuilt program decodes as the JAX decoder's."""
    Hgf4 = np.array([[1, 2, 0], [0, 3, 1]], dtype=np.uint8)
    jd, td = _pair(Hgf4=Hgf4, error_rate=0.1, max_iter=5)
    td.update_alpha(0.5)
    assert (td.alpha == 0.5).all()
    td.update_alpha(np.array([0.5, 0.75, 1.0]))
    assert (td.alpha[1] == 0.75).all()
    per_qubit = np.full((3, 3), 0.9)
    td.update_alpha(per_qubit)
    jd.update_alpha(per_qubit)
    assert (td.alpha == 0.9).all()
    td.update_alpha(None)  # no-op, as upstream
    assert (td.alpha == 0.9).all()
    with pytest.raises(ValueError):
        td.update_alpha(np.ones(7))
    out = td.decode(np.array([1, 0]))
    assert out.shape == (3,)
    np.testing.assert_array_equal(out, jd.decode(np.array([1, 0])))
    np.testing.assert_allclose(td.log_prob_ratios, jd.log_prob_ratios, rtol=1e-6, atol=1e-5)
