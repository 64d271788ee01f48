"""The port's decoders (ldpc_tpu_torch.BpDecoder/BpOsdDecoder) against the
JAX package's, on the same syndromes (made with numpy from a seed), and
the API-parity probes of the JAX package's own decoder tests."""

import functools
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, rep_code, surface_code

torch.set_num_threads(1)

KW = dict(max_iter=30, bp_method="minimum_sum", ms_scaling_factor=0.625)


def _syndromes(code_hx, B, p, seed=7):
    H = np.asarray(code_hx.todense(), np.uint8)
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return H, (errors @ H.T % 2).astype(np.uint8)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for d, B, p in [(5, 300, 0.05), (13, 1024, 0.01)]:
        hx = surface_code(d).hx
        H, syn = _syndromes(hx, B, p)
        syn[3] = 0  # a zero-syndrome row
        out[d] = (hx, H, syn, p)
    return out


@pytest.mark.parametrize("osd_method", ["osd_0", "osd_off"])
@pytest.mark.parametrize("d", [5, 13])
def test_bposd_decode_batch_matches_jax(cases, d, osd_method):
    hx, H, syn, p = cases[d]
    kw = dict(error_rate=p, osd_method=osd_method, **KW)
    jd = ldpc_tpu.BpOsdDecoder(hx, **kw)
    td = ldpc_tpu_torch.BpOsdDecoder(hx, **kw, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).all()
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    if osd_method == "osd_0":
        assert ((got @ H.T) % 2 == syn).all()
        assert not td.converge_batch.all()  # OSD-0 really ran
    assert (td.osd0_decoding_batch == got).all()
    assert (td.osdw_decoding_batch == got).all()
    assert (td.decoding == want[0]).all()
    assert td.converge == jd.converge and td.iter == jd.iter


def test_bposd_batch_properties_equal_full_depth_bp(cases):
    """Posteriors and BP decodings of the batch are the full-depth BP
    values of every row, as one single-phase BP run gives them."""
    hx, H, syn, p = cases[5]
    td = ldpc_tpu_torch.BpOsdDecoder(hx, error_rate=p, **KW, device="cpu")
    td.decode_batch(syn)
    bd = ldpc_tpu_torch.BpDecoder(hx, error_rate=p, **KW, device="cpu")
    bp_out = bd.decode_batch(syn)
    np.testing.assert_array_equal(td.log_prob_ratios_batch, bd.log_prob_ratios_batch)
    assert (td.bp_decoding_batch == bp_out).all()
    nz = syn.any(axis=1)
    assert (td.converge_batch == (bd.converge_batch | ~nz)).all()
    assert (td.iter_batch == bd.iter_batch).all()


@pytest.mark.parametrize("d", [5, 13])
def test_bp_decode_batch_matches_jax(cases, d):
    hx, H, syn, p = cases[d]
    jd = ldpc_tpu.BpDecoder(hx, error_rate=p, **KW)
    td = ldpc_tpu_torch.BpDecoder(hx, error_rate=p, **KW, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert (got == want).all()
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    np.testing.assert_allclose(
        td.log_prob_ratios_batch, np.asarray(jd.log_prob_ratios_batch), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("bp_method", ["minimum_sum", "product_sum"])
def test_bp_single_decode_matches_jax_exhaustive_hamming(bp_method):
    """Every syndrome of the [7,4] Hamming code, one at a time."""
    H = hamming_code(3)
    kw = dict(error_rate=0.05, max_iter=10, bp_method=bp_method, ms_scaling_factor=0.0)
    jd = ldpc_tpu.BpDecoder(H, **kw)
    td = ldpc_tpu_torch.BpDecoder(H, **kw, device="cpu")
    for bits in itertools.product([0, 1], repeat=3):
        s = np.array(bits, dtype=np.uint8)
        assert (td.decode(s) == jd.decode(s)).all()
        assert td.converge == jd.converge and td.iter == jd.iter


def test_received_vector_mode_matches_jax():
    H = rep_code(5)
    jd = ldpc_tpu.BpDecoder(H, error_rate=0.1, input_vector_type="received_vector")
    td = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, input_vector_type="received_vector", device="cpu")
    for rv in ([0, 1, 0, 0, 0], [1, 1, 0, 1, 1], [0, 0, 0, 0, 0]):
        rv = np.array(rv, dtype=np.uint8)
        assert (td.decode(rv) == jd.decode(rv)).all()
        assert td.converge == jd.converge


def test_bposd_single_decode_matches_batch_rows(cases):
    hx, H, syn, p = cases[5]
    td = ldpc_tpu_torch.BpOsdDecoder(hx, error_rate=p, **KW, device="cpu")
    batch = td.decode_batch(syn[:24])
    for i in range(24):
        assert (td.decode(syn[i]) == batch[i]).all(), i


def test_bposd_hamming_exhaustive_always_valid():
    H = hamming_code(3)
    d = ldpc_tpu_torch.BpOsdDecoder(H, error_rate=0.05, max_iter=8, osd_method="osd_0", device="cpu")
    for bits in itertools.product([0, 1], repeat=3):
        s = np.array(bits, dtype=np.uint8)
        out = d.decode(s)
        assert ((H @ out) % 2 == s).all()
        assert d.bp_decoding.shape == d.osd0_decoding.shape == d.osdw_decoding.shape == (7,)
        assert (d.decoding == out).all()
        if not d.converge:
            assert (d.osdw_decoding == out).all()


@pytest.mark.parametrize("cls", ["BpDecoder", "BpOsdDecoder"])
def test_bit_packed_io_kwargs(cls):
    code = surface_code(5)
    H, syn = _syndromes(code.hx, 32, 0.04, seed=3)
    packed = np.packbits(syn, axis=1, bitorder="little")
    dec = getattr(ldpc_tpu_torch, cls)(code.hx, error_rate=0.04, max_iter=12, device="cpu")
    want = dec.decode_batch(syn)
    got = dec.decode_batch(packed, bit_packed_syndromes=True)
    assert np.array_equal(want, got)
    got_packed = dec.decode_batch(packed, bit_packed_syndromes=True, bit_packed_output=True)
    assert np.array_equal(np.packbits(want, axis=1, bitorder="little"), got_packed)
    with pytest.raises(ValueError, match="Bit-packed"):
        dec.decode_batch(np.zeros((4, 99), np.uint8), bit_packed_syndromes=True)


# ---- API-parity probes --------------------------------------------------------


@pytest.mark.parametrize("cls", ["BpDecoder", "BpOsdDecoder"])
def test_plain_list_matrix_raises_type_error(cls):
    with pytest.raises(TypeError):
        getattr(ldpc_tpu_torch, cls)([[1, 1, 0], [0, 1, 1]], error_rate=0.1, device="cpu")


def test_constructor_defaults_and_validation():
    H = rep_code(3)
    d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, device="cpu")
    assert (d.check_count, d.bit_count) == (2, 3)
    assert d.bp_method == "minimum_sum" and d.schedule == "parallel"
    assert d.max_iter == 3  # 0 -> block length
    assert d.ms_scaling_factor == 1.0
    assert np.allclose(d.error_channel, 0.1)
    assert d.device == torch.device("cpu")
    for bad in (
        dict(),
        dict(error_rate=0.1, bp_method="nonsense"),
        dict(error_rate=0.1, schedule="nonsense"),
        dict(error_rate=0.1, max_iter=-1),
        dict(error_rate="0.1"),
        dict(error_rate=0.1, error_channel=[0.1, 0.2]),
        dict(error_rate=0.1, unknown_kwarg=1),
    ):
        with pytest.raises(ValueError):
            ldpc_tpu_torch.BpDecoder(H, **bad, device="cpu")
    for alias in ("ps", "product_sum", "prod_sum", "0"):
        assert ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, bp_method=alias, device="cpu").bp_method == "product_sum"
    for alias in ("ms", "minimum_sum", "min_sum", "1"):
        assert ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, bp_method=alias, device="cpu").bp_method == "minimum_sum"
    v1 = ldpc_tpu_torch.BpDecoder(H, channel_probs=[0.1, 0.2, 0.3], device="cpu")
    assert np.allclose(v1.error_channel, [0.1, 0.2, 0.3])
    v1.update_channel_probs([0.3, 0.2, 0.1])
    assert np.allclose(v1.channel_probs, [0.3, 0.2, 0.1])
    with pytest.raises(ValueError):
        ldpc_tpu_torch.BpDecoder(np.eye(3, dtype=np.uint8), error_rate=0.1, device="cpu")  # square: auto
    with pytest.warns(UserWarning):
        ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, omp_thread_count=4, device="cpu")


def test_unported_options_raise_not_implemented():
    """Nothing of these options is refused any more: float64 BP+LSD,
    BeliefFind and BP+flip, and single-scan in float64, decode as the JAX
    decoders at ``jnp.float64`` do (every syndrome of the rep code); the
    serial schedules and float64 BP+OSD are ported too."""
    import jax.numpy as jnp

    H = rep_code(3)
    syn = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.uint8)
    for name in ("BpLsdDecoder", "BeliefFindDecoder", "BpFlipDecoder"):
        jd = getattr(ldpc_tpu, name)(H, error_rate=0.1, dtype=jnp.float64)
        td = getattr(ldpc_tpu_torch, name)(H, error_rate=0.1, dtype=torch.float64, device="cpu")
        assert (td.decode_batch(syn) == jd.decode_batch(syn)).all()
        assert (td.converge_batch == jd.converge_batch).all()
    d64 = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, dtype=np.float64, device="cpu")
    j64 = ldpc_tpu.BpDecoder(H, error_rate=0.1, dtype=jnp.float64)
    for s in syn[1:]:
        assert (d64.decode_single_scan(s) == j64.decode_single_scan(s)).all()
        assert (d64.converge, d64.iter) == (j64.converge, j64.iter)
        assert d64.log_prob_ratios.dtype == np.float64
    for schedule in ("serial", "serial_relative"):
        d = ldpc_tpu_torch.BpDecoder(H, error_rate=0.1, schedule=schedule, device="cpu")
        assert d.schedule == schedule
    d = ldpc_tpu_torch.BpOsdDecoder(H, error_rate=0.1, dtype="float64", device="cpu")
    assert (d.decode_batch(np.array([[1, 0]], np.uint8)) == [[1, 0, 0]]).all()
    assert d.log_prob_ratios_batch.dtype == np.float64
    # OSD-CS and LSD's per-cluster statistics are ported now
    d = ldpc_tpu_torch.BpOsdDecoder(H, error_rate=0.1, osd_method="osd_cs", osd_order=2, device="cpu")
    assert (d.decode_batch(np.array([[1, 0]], np.uint8)) == [[1, 0, 0]]).all()
    lsd = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=1, always_run_lsd=True, device="cpu")
    lsd.set_do_stats(True)
    lsd.decode_batch(np.array([[1, 0]], np.uint8))
    assert list(lsd.statistics.individual_cluster_stats) == [0]


def test_osd_method_aliases_and_order_validation():
    H = rep_code(3)
    D = functools.partial(ldpc_tpu_torch.BpOsdDecoder, device="cpu")
    d = D(H, error_rate=0.1)
    assert (d.osd_method, d.osd_order, d.input_vector_type) == ("OSD_0", 0, "syndrome")
    for alias in ("osd_0", "0", "osd0"):
        assert D(H, error_rate=0.1, osd_method=alias).osd_method == "OSD_0"
    for alias in ("osd_e", "e", "exhaustive"):
        assert D(H, error_rate=0.1, osd_method=alias, osd_order=2).osd_method == "OSD_E"
    for alias in ("osd_cs", "1", "cs", "combination_sweep"):
        assert D(H, error_rate=0.1, osd_method=alias, osd_order=2).osd_method == "OSD_CS"
    for alias in ("off", "osd_off", "deactivated"):
        assert D(H, error_rate=0.1, osd_method=alias).osd_method == "OSD_OFF"
    with pytest.raises(ValueError):
        D(H, error_rate=0.1, osd_method="nonsense")
    with pytest.raises(ValueError):
        D(H, error_rate=0.1, osd_method="osd_e", osd_order=-1)
    with pytest.raises(ValueError):
        d.osd_order = 2  # OSD_0 requires order 0
    with pytest.warns(UserWarning):
        D(H, error_rate=0.1, osd_method="osd_e", osd_order=16)


@pytest.mark.parametrize("cls", ["BpDecoder", "BpOsdDecoder"])
def test_zero_syndrome_converges_to_zeros(cls):
    H = rep_code(5)
    d = getattr(ldpc_tpu_torch, cls)(H, error_rate=0.1, input_vector_type="syndrome", device="cpu")
    out = d.decode(np.zeros(4, dtype=np.uint8))
    assert not out.any()
    assert d.converge


@pytest.mark.parametrize("cls", ["BpDecoder", "BpOsdDecoder"])
def test_length_validation(cls):
    d = getattr(ldpc_tpu_torch, cls)(rep_code(5), error_rate=0.1, input_vector_type="syndrome", device="cpu")
    with pytest.raises(ValueError):
        d.decode(np.zeros(5, dtype=np.uint8))
    with pytest.raises(ValueError):
        d.decode_batch(np.zeros((2, 5), dtype=np.uint8))


@pytest.mark.parametrize("cls", ["BpDecoder", "BpOsdDecoder"])
def test_scipy_and_numpy_inputs_identical(cls):
    code = surface_code(5)
    H, syn = _syndromes(code.hx, 64, 0.05, seed=5)
    a = getattr(ldpc_tpu_torch, cls)(scipy.sparse.csr_matrix(H), error_rate=0.05, **KW, device="cpu")
    b = getattr(ldpc_tpu_torch, cls)(H, error_rate=0.05, **KW, device="cpu")
    assert (a.decode_batch(syn) == b.decode_batch(syn)).all()
    assert (a.converge_batch == b.converge_batch).all()
    assert (a.iter_batch == b.iter_batch).all()


def test_port_imports_no_jax():
    """A fresh process imports the port, decodes on the CPU and never
    imports jax or the JAX package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, numpy as np\n"
        "import ldpc_tpu_torch\n"
        "from ldpc_tpu_torch.codes import surface_code\n"
        "from ldpc_tpu_torch.monte_carlo_simulation import make_mc_decoder_step\n"
        "code = surface_code(3)\n"
        "d = ldpc_tpu_torch.BpOsdDecoder(code.hx, error_rate=0.1, max_iter=10,\n"
        "                                device='cpu')\n"
        "H = np.asarray(code.hx.todense(), np.uint8)\n"
        "s = (np.eye(1, H.shape[1], 4, dtype=np.uint8) @ H.T % 2)[0]\n"
        "x = d.decode(s)\n"
        "assert ((H @ x) % 2 == s).all()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'ldpc_tpu']\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=repo, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
