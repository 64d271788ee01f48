"""The port's decoders on the serial schedules, float64, single-scan and
soft information, on the CPU: the reference C++ decoder's golden fixtures,
the JAX package's decoders on the same syndromes, and the behaviour tests
of tests/test_bp_decoder.py run on the port.

- ``bp_golden.npz`` (reference C++ decodings, float64): min-sum is held bit
  for bit, posteriors included (the JAX package holds them to 1e-9); the
  product-sum tiers are tests/test_bp_golden.py's.
- ``osd_golden.npz``: tests/test_osd_golden.py's bar.
- Against JAX: flags and BP decodings identical; where BP fails, OSD and
  LSD may take another equally good solution on a few rows, because JAX's
  serial posteriors are an ulp off the reference's (ROADMAP queue 3) and
  OSD orders its columns by them, and because JAX's OSD-w sums candidate
  weights by einsum (queue 3, OSD-w ties): such a row must solve H x = s
  with the same weight.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, rep_code, ring_code, surface_code
from ldpc_tpu.mod2 import rank as gf2_rank

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BP = np.load(os.path.join(FIXTURES, "bp_golden.npz"))
OSD = np.load(os.path.join(FIXTURES, "osd_golden.npz"))

GOLDEN_CONFIGS = [(0, 1, 1.0), (0, 0, 1.0), (0, 2, 1.0), (1, 1, 1.0), (1, 1, 0.625),
                  (1, 1, 0.0), (1, 0, 1.0), (1, 0, 0.625), (1, 2, 0.625)]
SCHED_NAME = {0: "serial", 1: "parallel", 2: "serial_relative"}
METHOD_NAME = {0: "product_sum", 1: "minimum_sum"}


def _llr_err(got, want):
    """Max abs error over entries where both are finite and equal-signed inf."""
    with np.errstate(invalid="ignore"):
        err = np.abs(got - want)
    err = np.where(np.isnan(want) & np.isnan(got), 0.0, err)
    err = np.where(np.isinf(want) & (want == got), 0.0, err)
    return np.nanmax(err) if err.size else 0.0


@pytest.mark.parametrize("config", GOLDEN_CONFIGS, ids=lambda c: f"m{c[0]}_s{c[1]}_a{c[2]}")
@pytest.mark.parametrize("cname", ["hamming3", "rep7", "ring8"])
def test_golden_bp_replay(cname, config):
    method, sched, alpha = config
    H, syndromes = BP[f"{cname}/pcm"], BP[f"{cname}/syndromes"]
    key = f"{cname}/{method}_{sched}_{alpha}"
    want_conv = BP[f"{key}/conv"].astype(bool)
    want_iters, want_dec, want_llr = BP[f"{key}/iters"], BP[f"{key}/dec"], BP[f"{key}/llr"]
    d = ldpc_tpu_torch.BpDecoder(
        H, error_channel=BP[f"{cname}/channel"], max_iter=20,
        bp_method=METHOD_NAME[method], schedule=SCHED_NAME[sched], ms_scaling_factor=alpha,
        input_vector_type="syndrome", dtype=torch.float64, device="cpu",
    )
    got_dec = d.decode_batch(syndromes)
    got_conv, got_iters = d.converge_batch.astype(bool), d.iter_batch
    got_llr = d.log_prob_ratios_batch
    assert got_llr.dtype == np.float64
    if method == 1:  # min-sum: bit for bit, posteriors included
        assert (got_conv == want_conv).all()
        assert (got_dec == want_dec).all()
        assert (got_iters == want_iters).all()
        assert _llr_err(got_llr, want_llr) == 0.0
    elif sched == 1:
        assert (got_conv == want_conv).all()
        assert (got_dec == want_dec).all()
        assert (got_iters == want_iters).all()
        assert _llr_err(got_llr, want_llr) < 1e-4
    elif sched == 0:
        assert (got_conv == want_conv).all()
        assert (got_dec[want_conv] == want_dec[want_conv]).all()
        assert (got_iters[want_conv] == want_iters[want_conv]).all()
    else:
        assert abs(int(got_conv.sum()) - int(want_conv.sum())) <= 8
        assert (got_dec[got_conv] @ H.T % 2 == syndromes[got_conv]).all()


def _in_image(H, syndromes):
    r = gf2_rank(H)
    return np.array([gf2_rank(np.hstack([H, s[:, None]])) == r for s in syndromes])


@pytest.mark.parametrize("config", [(0, 0), (1, 4), (2, 4), (2, 0)],
                         ids=lambda c: f"m{c[0]}_o{c[1]}")
@pytest.mark.parametrize("cname", ["hamming3", "ring8", "surface3"])
def test_golden_osd_replay(cname, config):
    osd_method, osd_order = config
    H, syndromes = OSD[f"{cname}/pcm"], OSD[f"{cname}/syndromes"]
    key = f"{cname}/{osd_method}_{osd_order}"
    d = ldpc_tpu_torch.BpOsdDecoder(
        H, error_channel=OSD[f"{cname}/channel"], max_iter=5, bp_method="minimum_sum",
        ms_scaling_factor=0.625, schedule="parallel",
        osd_method={0: "osd_0", 1: "osd_e", 2: "osd_cs"}[osd_method], osd_order=osd_order,
        dtype=np.float64, device="cpu",
    )
    got = d.decode_batch(syndromes)
    zero = ~syndromes.any(axis=1)
    assert (d.converge_batch[~zero] == OSD[f"{key}/conv"].astype(bool)[~zero]).all()
    ok = _in_image(H, syndromes)
    assert (got[ok] == OSD[f"{key}/dec"][ok]).all()
    assert (d.osd0_decoding_batch[ok] == OSD[f"{key}/osd0"][ok]).all()
    assert (d.osdw_decoding_batch[ok] == OSD[f"{key}/osdw"][ok]).all()
    assert ((got[ok] @ H.T % 2) == syndromes[ok]).all()


@pytest.fixture(scope="module")
def surface5():
    H = surface_code(5).hx
    rng = np.random.default_rng(7)
    errors = (rng.random((200, H.shape[1])) < 0.05).astype(np.uint8)
    return H, (errors @ H.toarray().T % 2).astype(np.uint8)


def _assert_equal_or_equally_good(got, want, H, syn, max_rows):
    """Rows that differ solve H x = s with the same weight (the channel is
    uniform, so the same OSD weight), and there are at most ``max_rows``."""
    Hd = np.asarray(H.todense() if hasattr(H, "todense") else H)
    assert ((got.astype(np.int64) @ Hd.T % 2) == syn).all()
    rows = np.flatnonzero((got != want).any(axis=1))
    assert len(rows) <= max_rows, rows
    assert (got[rows].sum(axis=1) == want[rows].sum(axis=1)).all()


BP_KW = dict(error_rate=0.05, max_iter=20, bp_method="ms", ms_scaling_factor=0.625)


@pytest.mark.parametrize("post", [
    ("BpOsdDecoder", dict(osd_method="osd_0")),
    ("BpOsdDecoder", dict(osd_method="osd_cs", osd_order=4)),
    ("BpLsdDecoder", dict(lsd_method="lsd_0")),
    ("BpLsdDecoder", dict(lsd_method="lsd_cs", lsd_order=4)),
], ids=lambda p: f"{p[0]}-{next(iter(p[1].values()))}")
@pytest.mark.parametrize("schedule", ["serial", "serial_relative"])
def test_post_processed_serial_matches_jax(surface5, schedule, post):
    H, syn = surface5
    cls, kw = post
    want_dec = getattr(ldpc_tpu, cls)(H, schedule=schedule, **BP_KW, **kw)
    got_dec = getattr(ldpc_tpu_torch, cls)(H, schedule=schedule, device="cpu", **BP_KW, **kw)
    want, got = want_dec.decode_batch(syn), got_dec.decode_batch(syn)
    assert (got_dec.converge_batch == want_dec.converge_batch).all()
    conv = got_dec.converge_batch
    assert (got_dec.iter_batch[conv] == want_dec.iter_batch[conv]).all()
    assert (got[conv] == want[conv]).all()
    _assert_equal_or_equally_good(got, want, H, syn, max_rows=4)


@pytest.mark.parametrize("kw", [dict(osd_method="osd_0"), dict(osd_method="osd_cs", osd_order=4),
                                dict(osd_method="osd_e", osd_order=4)],
                         ids=lambda k: k["osd_method"])
def test_bposd_float64_matches_jax(surface5, kw):
    """Float64 BP is bit for bit; OSD-0 too; OSD-w may break a tie of equal
    weights the other way (3 of 200 rows here)."""
    H, syn = surface5
    want_dec = ldpc_tpu.BpOsdDecoder(H, dtype=jnp.float64, **BP_KW, **kw)
    got_dec = ldpc_tpu_torch.BpOsdDecoder(H, dtype=torch.float64, device="cpu", **BP_KW, **kw)
    want, got = want_dec.decode_batch(syn), got_dec.decode_batch(syn)
    assert (got_dec.converge_batch == want_dec.converge_batch).all()
    assert (got_dec.iter_batch == want_dec.iter_batch).all()
    np.testing.assert_array_equal(got_dec.log_prob_ratios_batch,
                                  np.asarray(want_dec.log_prob_ratios_batch))
    assert (got_dec.osd0_decoding_batch == np.asarray(want_dec.osd0_decoding_batch)).all()
    _assert_equal_or_equally_good(got, want, H, syn, max_rows=5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_soft_info_bposd_matches_jax(surface5, dtype):
    """Flags identical; BP's converged rows identical; the OSD rows solve
    the hardened final soft syndrome, and equal JAX's where the
    posteriors that order OSD's columns agree to the ulp."""
    H, syn = surface5
    rng = np.random.default_rng(7)
    soft = (1 - 2 * syn.astype(np.float64)) + 0.3 * rng.standard_normal(syn.shape)
    kw = dict(error_rate=0.05, max_iter=20, ms_scaling_factor=0.625, cutoff=10.0, sigma=0.3,
              dtype=dtype)
    want_dec = ldpc_tpu.SoftInfoBpOsdDecoder(H, **kw)
    got_dec = ldpc_tpu_torch.SoftInfoBpOsdDecoder(H, device="cpu", **kw)
    want, got = want_dec.decode_batch(soft), got_dec.decode_batch(soft)
    conv = got_dec.converge_batch
    assert (conv == want_dec.converge_batch).all() and (~conv).any()
    assert (got[conv] == want[conv]).all()
    hard = (got_dec.soft_syndrome_batch <= 0).astype(np.uint8)
    assert ((got[~conv].astype(np.int64) @ H.toarray().T % 2) == hard[~conv]).all()
    same_llr = (got_dec.log_prob_ratios_batch == np.asarray(want_dec.log_prob_ratios_batch)).all(1)
    rows = ~conv & same_llr
    assert (got[rows] == want[rows]).all()
    assert got_dec.soft_syndrome.shape == (H.shape[0],)


# ---- tests/test_bp_decoder.py's behaviour tests, on the port -----------------


@pytest.mark.parametrize("bp_method", ["product_sum", "minimum_sum"])
@pytest.mark.parametrize("schedule", ["parallel", "serial", "serial_relative"])
def test_hamming_exhaustive_valid(bp_method, schedule):
    """All 2^m syndromes of Hamming(3): converged decodings satisfy H x = s,
    and the port converges on the same syndromes as JAX."""
    H = hamming_code(3)
    m = H.shape[0]
    kw = dict(error_rate=0.05, max_iter=20, bp_method=bp_method, schedule=schedule,
              input_vector_type="syndrome")
    d = ldpc_tpu_torch.BpDecoder(H, device="cpu", **kw)
    dj = ldpc_tpu.BpDecoder(H, **kw)
    n_conv = 0
    for bits in itertools.product([0, 1], repeat=m):
        s = np.array(bits, dtype=np.uint8)
        out = d.decode(s)
        dj.decode(s)
        assert d.converge == dj.converge
        if d.converge:
            n_conv += 1
            assert ((H @ out) % 2 == s).all()
    floor = 2**m - 2 if schedule == "parallel" else 4
    assert n_conv >= floor


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("schedule", ["parallel", "serial", "serial_relative"])
def test_decode_batch_matches_loop(schedule, dtype):
    H = ring_code(8)
    d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, max_iter=15, schedule=schedule,
                                 input_vector_type="syndrome", dtype=dtype, device="cpu")
    rng = np.random.default_rng(7)
    syndromes = rng.integers(0, 2, size=(12, H.shape[0]), dtype=np.uint8)
    batch_out = d.decode_batch(syndromes)
    conv, iters = d.converge_batch.copy(), d.iter_batch.copy()
    llrs = d.log_prob_ratios_batch
    assert llrs.dtype == dtype
    for i in range(syndromes.shape[0]):
        single = d.decode(syndromes[i])
        assert (batch_out[i] == single).all(), i
        assert d.converge == conv[i] and d.iter == iters[i]
        np.testing.assert_array_equal(d.log_prob_ratios, llrs[i])


def test_serial_schedule_order():
    H = rep_code(4)
    order = [3, 2, 1, 0]
    d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, schedule="serial",
                                 serial_schedule_order=order, input_vector_type="syndrome",
                                 device="cpu")
    assert (d.serial_schedule_order == order).all()
    out = d.decode(np.array([1, 0, 0], dtype=np.uint8))
    assert ((H @ out) % 2 == [1, 0, 0]).all()
    with pytest.raises(Exception):
        d.serial_schedule_order = [0, 1]  # wrong length


def test_serial_schedule_order_matches_jax():
    """A given order changes the serial sweep, identically on both sides."""
    H = ring_code(10)
    rng = np.random.default_rng(3)
    syn = rng.integers(0, 2, size=(16, 10), dtype=np.uint8)
    order = [int(i) for i in rng.permutation(10)]
    kw = dict(error_rate=0.1, max_iter=10, schedule="serial", serial_schedule_order=order,
              ms_scaling_factor=0.75, input_vector_type="syndrome", dtype=np.float64)
    d, dj = ldpc_tpu_torch.BpDecoder(H, device="cpu", **kw), ldpc_tpu.BpDecoder(H, **kw)
    assert (d.decode_batch(syn) == dj.decode_batch(syn)).all()
    assert (d.iter_batch == dj.iter_batch).all()


@pytest.mark.parametrize("alias,name", [("s", "serial"), ("1", "serial"), ("sr", "serial_relative"),
                                        ("2", "serial_relative"), ("p", "parallel")])
def test_schedule_aliases(alias, name):
    d = ldpc_tpu_torch.BpDecoder(rep_code(3), error_rate=0.1, schedule=alias, device="cpu")
    assert d.schedule == name == ldpc_tpu.BpDecoder(rep_code(3), error_rate=0.1,
                                                    schedule=alias).schedule


def test_random_serial_schedule():
    """A fixed seed draws the same permutations on every call; every
    converged decoding solves H x = s; BpOsd with it is always valid."""
    H = surface_code(3).hx
    rng = np.random.default_rng(5)
    syn = (((rng.random((64, H.shape[1])) < 0.08).astype(np.uint8) @ H.toarray().T) % 2).astype(
        np.uint8)
    d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.05, max_iter=10, schedule="serial",
                                 random_serial_schedule=True, random_schedule_seed=9,
                                 device="cpu")
    assert d.random_serial_schedule
    a = d.decode_batch(syn)
    conv, b = d.converge_batch.copy(), d.decode_batch(syn)
    assert (a == b).all() and (conv == d.converge_batch).all()
    assert ((a[conv].astype(np.int64) @ H.toarray().T % 2) == syn[conv]).all()
    osd = ldpc_tpu_torch.BpOsdDecoder(H, error_rate=0.05, max_iter=10, schedule="serial",
                                      random_serial_schedule=True, device="cpu")
    out = osd.decode_batch(syn)
    assert ((out.astype(np.int64) @ H.toarray().T % 2) == syn).all()


class TestSoftInfoBpDecoder:
    def test_constructor(self):
        H = rep_code(3)
        d = ldpc_tpu_torch.SoftInfoBpDecoder(H, error_rate=0.1, cutoff=10.0, device="cpu")
        assert d.cutoff == 10.0
        assert d.sigma == 2.0
        assert d.bp_method == "minimum_sum" and d.schedule == "serial"
        with pytest.raises(ValueError):
            ldpc_tpu_torch.SoftInfoBpDecoder(H, error_rate=0.1, sigma=-1.0, device="cpu")

    def test_confident_syndrome_matches_hard_bp(self):
        """Large soft magnitudes (above any message) behave like hard BP."""
        H = rep_code(5)
        hard = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, schedule="serial",
                                        input_vector_type="syndrome", device="cpu")
        soft = ldpc_tpu_torch.SoftInfoBpDecoder(H, error_rate=0.1, cutoff=0.0, device="cpu")
        s = np.array([1, 0, 0, 0], dtype=np.uint8)
        out_hard = hard.decode(s)
        out_soft = soft.decode(np.where(s == 1, -20.0, 20.0))
        assert (out_hard == out_soft).all()
        assert soft.converge

    def test_weak_syndrome_flip(self):
        """A barely-negative syndrome bit can be virtually flipped to zero."""
        H = rep_code(5)
        d = ldpc_tpu_torch.SoftInfoBpDecoder(H, error_rate=0.01, cutoff=np.inf, sigma=1.0,
                                             device="cpu")
        out = d.decode(np.array([20.0, -0.01, 20.0, 20.0]))
        assert d.converge
        assert not out.any()
        assert d.soft_syndrome.shape == (4,)
        assert d.soft_syndrome[1] > 0  # the flipped check's soft value

    @pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
    def test_batch_matches_jax(self, dtype):
        H = ring_code(12)
        rng = np.random.default_rng(11)
        s = rng.integers(0, 2, size=(24, 12))
        soft = (1 - 2.0 * s) * 4 + rng.standard_normal(s.shape)
        kw = dict(error_rate=0.1, max_iter=12, ms_scaling_factor=0.8, cutoff=3.0, sigma=1.5,
                  dtype=dtype)
        d = ldpc_tpu_torch.SoftInfoBpDecoder(H, device="cpu", **kw)
        dj = ldpc_tpu.SoftInfoBpDecoder(H, **kw)
        np.testing.assert_array_equal(d.decode_batch(soft), dj.decode_batch(soft))
        np.testing.assert_array_equal(d.converge_batch, dj.converge_batch)
        np.testing.assert_array_equal(d.iter_batch, dj.iter_batch)
        tol = 1e-12 if dtype == np.float64 else 1e-6
        np.testing.assert_allclose(d.soft_syndrome_batch, dj.soft_syndrome_batch, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(d.log_prob_ratios_batch, dj.log_prob_ratios_batch,
                                   rtol=tol, atol=tol)


def test_single_scan_golden():
    """Golden values of the reference's single-scan decoder: rep_code(3),
    p=0.1, min-sum alpha=0.625, all 4 syndromes."""
    H = rep_code(3)
    d = ldpc_tpu_torch.BpDecoder(H, error_channel=[0.1, 0.1, 0.1], max_iter=3, bp_method="ms",
                                 ms_scaling_factor=0.625, device="cpu")
    expected = {(0, 0): [0, 0, 0], (0, 1): [0, 0, 1], (1, 0): [1, 0, 0], (1, 1): [0, 1, 0]}
    for syndrome, want in expected.items():
        out = d.decode_single_scan(np.array(syndrome, dtype=np.uint8))
        assert out.tolist() == want, (syndrome, out)


def test_single_scan_matches_parallel_min_sum():
    """Single-scan's recurrence is the parallel min-sum schedule's."""
    H = hamming_code(3)
    d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.05, max_iter=20, bp_method="ms",
                                 ms_scaling_factor=0.8, device="cpu")
    m = H.shape[0]
    for s_int in range(2**m):
        syndrome = np.array([(s_int >> i) & 1 for i in range(m)], np.uint8)
        out_ss = d.decode_single_scan(syndrome)
        conv_ss = d.converge
        out_par = d.decode(syndrome)
        assert out_ss.tolist() == out_par.tolist()
        assert conv_ss == d.converge


def test_single_scan_zero_alpha_is_fixed():
    """ms_scaling_factor=0 keeps messages at zero in single-scan (no
    dynamic alpha): nothing converges on a nonzero syndrome unless the
    prior already satisfies it."""
    H = rep_code(5)
    d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, max_iter=10, ms_scaling_factor=0.0,
                                 device="cpu")
    s = np.zeros(4, np.uint8)
    s[0] = 1
    d.decode_single_scan(s)
    assert not d.converge
