"""The union-find decoders of the port (ldpc_tpu_torch.ops.uf's
make_uf_decoder and make_peel_decoder, UnionFindDecoder, BeliefFindDecoder;
kernel K4') held against the JAX package, and ports of the JAX package's
tests/test_union_find.py.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU. On CPU tensors the port runs each kernel's plain PyTorch
version. The outputs are bits and flags, so every comparison is exact.

Peeling: on the CPU the JAX package builds an explicit BFS forest and peels
it, which may return a different, equally valid correction; on its fused
path (the TPU's) it solves each grown cluster once more in the order
[interior, boundary] (``forest_solve``). The port always does the latter.
Patching ``ldpc_tpu.ops.uf.make_masked_solver_or_none`` to return the
interpret-mode Pallas solver makes the JAX package take that path on the
CPU, and there the port must equal it bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, rep_code, ring_code, surface_code
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops import uf as juf
from ldpc_tpu.ops.gf2_pallas import make_masked_solver
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import uf as tuf

torch.set_num_threads(1)

KW = dict(max_iter=30, bp_method="minimum_sum", ms_scaling_factor=0.625)


def _all_syndromes(m):
    return ((np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package on its fused cluster-solver path, with the Pallas
    masked solver in interpret mode."""
    monkeypatch.setattr(
        juf, "make_masked_solver_or_none",
        lambda graph, dtype: make_masked_solver(graph, interpret=True),
    )


@pytest.fixture(scope="module")
def surface5():
    """Surface d=5 syndromes with BP posteriors (4 iterations) as LLRs."""
    graph = compile_pcm(surface_code(5).hx)
    rng = np.random.default_rng(3)
    errors = (rng.random((128, graph.n)) < 0.06).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llr0 = jbp.channel_llr(np.full(graph.n, 0.06))
    bp = jbp.make_parallel_decoder(graph, jbp.MINIMUM_SUM, 4, 0.625)
    llrs = np.array(bp(jnp.asarray(syn), jnp.asarray(llr0)).llr_posterior)
    return graph, syn, llrs


def _port(maker, graph, bits_per_step, syn, llrs):
    dec, valid = maker(graph, bits_per_step, "cpu")(torch.from_numpy(syn), torch.from_numpy(llrs))
    assert dec.dtype == torch.uint8 and valid.dtype == torch.bool
    return dec.numpy(), valid.numpy()


def _jax(maker, graph, bits_per_step, syn, llrs):
    dec, valid = maker(graph, bits_per_step)(jnp.asarray(syn), jnp.asarray(llrs))
    return np.asarray(dec), np.asarray(valid)


@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("bits_per_step", [0, 1, "n"])
def test_make_uf_decoder_matches_jax(request, surface5, engine, bits_per_step):
    """Inversion mode against the JAX package's XLA engine and its fused
    (interpret-mode) engine: equal decodings and validity."""
    graph, syn, llrs = surface5
    bps = graph.n if bits_per_step == "n" else bits_per_step
    if engine == "fused":
        request.getfixturevalue("fused_jax")
    want = _jax(juf.make_uf_decoder, graph, bps, syn, llrs)
    got = _port(tuf.make_uf_decoder, graph, bps, syn, llrs)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert got[1].all()
    assert ((got[0] @ graph.dense.T) % 2 == syn).all()


@pytest.mark.parametrize("bits_per_step", [0, 1, "n"])
def test_make_peel_decoder_matches_jax_forest_solve(surface5, fused_jax, bits_per_step):
    graph, syn, llrs = surface5
    bps = graph.n if bits_per_step == "n" else bits_per_step
    want = _jax(juf.make_peel_decoder, graph, bps, syn, llrs)
    got = _port(tuf.make_peel_decoder, graph, bps, syn, llrs)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert ((got[0] @ graph.dense.T) % 2 == syn).all()


@pytest.mark.parametrize("bits_per_step", [0, 1])
def test_make_peel_decoder_against_jax_cpu_peeling(surface5, bits_per_step):
    """Against the JAX package's BFS-forest peeling: equal validity, and
    both solve H x = s on every valid lane."""
    graph, syn, llrs = surface5
    want = _jax(juf.make_peel_decoder, graph, bits_per_step, syn, llrs)
    got = _port(tuf.make_peel_decoder, graph, bits_per_step, syn, llrs)
    assert (got[1] == want[1]).all() and got[1].all()
    for dec in (got[0], want[0]):
        assert ((dec @ graph.dense.T) % 2 == syn).all()


def test_make_peel_decoder_rejects_high_degree():
    with pytest.raises(ValueError, match="column degree <= 2"):
        tuf.make_peel_decoder(compile_pcm(hamming_code(3)), device="cpu")


def test_peel_ring_code_odd_parity_is_invalid():
    """A ring code has no boundary column: an odd-parity syndrome never
    becomes valid, in the port as in the JAX package."""
    graph = compile_pcm(ring_code(7))
    syn = _all_syndromes(7)
    llrs = np.zeros((syn.shape[0], graph.n), np.float32)
    got = _port(tuf.make_peel_decoder, graph, 0, syn, llrs)
    odd = syn.sum(axis=1) % 2 == 1
    assert (got[1] == ~odd).all()


# ----------------------------------------------------------------------
# UnionFindDecoder
# ----------------------------------------------------------------------
@pytest.mark.parametrize("uf_method", [True, False], ids=["matrix", "peeling"])
@pytest.mark.parametrize("guided", [False, True])
def test_union_find_decoder_matches_jax(surface5, fused_jax, uf_method, guided):
    """``decode_batch`` against the JAX decoder (fused path): unguided, and
    guided by one LLR vector shared by every row (broadcast on the device)
    with ``bits_per_step=1``."""
    graph, syn, llrs = surface5
    code = surface_code(5)
    kw = dict(llrs=llrs[0], bits_per_step=1) if guided else {}
    jd = ldpc_tpu.UnionFindDecoder(code.hx, uf_method=uf_method)
    td = ldpc_tpu_torch.UnionFindDecoder(code.hx, uf_method=uf_method, device="cpu")
    syn = syn.copy()
    syn[5] = 0
    want = jd.decode_batch(syn, **kw)
    got = td.decode_batch(syn, **kw)
    assert got.dtype == np.uint8 and (got == want).all()
    assert (td.valid_batch == jd.valid_batch).all() and td.valid_batch.all()
    assert (td.decoding == jd.decoding).all()
    assert not got[5].any()


def test_uf_matrix_exhaustive_hamming():
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.UnionFindDecoder(H, uf_method=True, device="cpu")
    syn = _all_syndromes(3)
    out = dec.decode_batch(syn)
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, syn)
    assert (out == ldpc_tpu.UnionFindDecoder(H, uf_method=True).decode_batch(syn)).all()


def test_uf_peel_rep_code_exhaustive():
    H = rep_code(6)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.UnionFindDecoder(H, uf_method=False, device="cpu")
    syn = _all_syndromes(5)
    out = dec.decode_batch(syn)
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, syn)


def test_uf_peel_ring_code():
    H = ring_code(7)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.UnionFindDecoder(H, uf_method=False, device="cpu")
    syn = _all_syndromes(7)
    even = syn[syn.sum(axis=1) % 2 == 0]
    out = dec.decode_batch(even)
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, even)


def test_uf_validation():
    D = functools.partial(ldpc_tpu_torch.UnionFindDecoder, device="cpu")
    with pytest.raises(ValueError, match="planar codes"):
        D(hamming_code(3), uf_method=False)
    with pytest.raises(ValueError, match="Column weight is zero"):
        D(np.array([[1, 0, 0], [0, 1, 0]], dtype=np.uint8), uf_method=True)
    with pytest.raises(TypeError):
        D([[1, 1, 0], [0, 1, 1]])
    dec = D(rep_code(5))
    with pytest.raises(ValueError, match="syndrome must have length 4"):
        dec.decode(np.zeros(5, np.uint8))
    with pytest.raises(ValueError, match="llrs must have length 5"):
        dec.decode(np.zeros(4, np.uint8), llrs=np.zeros(3))


def test_uf_matrix_guided_by_llrs():
    H = rep_code(8)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.UnionFindDecoder(H, uf_method=True, device="cpu")
    e = np.zeros(8, np.uint8)
    e[3] = 1
    s = Hd @ e % 2
    llrs = np.full(8, 5.0)
    llrs[3] = -2.0  # bit 3 most suspect
    out = dec.decode(s, llrs=llrs, bits_per_step=1)
    assert np.array_equal(Hd @ out % 2, s)
    assert out[3] == 1


def test_uf_single_vs_batch():
    H = hamming_code(3)
    dec = ldpc_tpu_torch.UnionFindDecoder(H, uf_method=True, device="cpu")
    syn = _all_syndromes(3)
    batch = dec.decode_batch(syn)
    for i, s in enumerate(syn):
        assert np.array_equal(dec.decode(s), batch[i])


def test_uf_zero_syndrome():
    dec = ldpc_tpu_torch.UnionFindDecoder(rep_code(5), device="cpu")
    x = dec.decode(np.zeros(4, np.uint8))
    assert not x.any() and dec.valid_batch.all()


# ----------------------------------------------------------------------
# BeliefFindDecoder (BP + UF)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def d13():
    hx = surface_code(13).hx
    H = np.asarray(hx.todense(), np.uint8)
    rng = np.random.default_rng(7)
    errors = (rng.random((1024, H.shape[1])) < 0.01).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    syn[3] = 0  # a zero-syndrome row
    return hx, H, syn


@pytest.mark.parametrize("uf_method", ["inversion", "peeling"])
def test_belief_find_decode_batch_matches_jax(d13, fused_jax, uf_method):
    """The slice end to end: ``BeliefFindDecoder`` on 1,024 d=13 syndromes
    against the JAX decoder (fused cluster-solver path), exactly."""
    hx, H, syn = d13
    jd = ldpc_tpu.BeliefFindDecoder(hx, error_rate=0.01, uf_method=uf_method, **KW)
    td = ldpc_tpu_torch.BeliefFindDecoder(hx, error_rate=0.01, uf_method=uf_method, **KW, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert got.dtype == np.uint8 and (got == want).all()
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    assert ((got @ H.T) % 2 == syn).all()
    assert (~td.converge_batch).sum() > 50  # the UF stage really ran
    assert (td.decoding == want[0]).all()
    assert td.converge == jd.converge and td.iter == jd.iter


@pytest.mark.parametrize("uf_method", ["inversion", "peeling"])
def test_belief_find_surface_code(uf_method):
    code = surface_code(5)
    Hd = np.asarray(code.hx.todense(), np.uint8)
    dec = ldpc_tpu_torch.BeliefFindDecoder(
        code.hx, error_rate=0.05, max_iter=5, bp_method="minimum_sum",
        ms_scaling_factor=0.625, uf_method=uf_method, bits_per_step=1, device="cpu",
    )
    rng = np.random.default_rng(149)
    errors = (rng.random((128, Hd.shape[1])) < 0.05).astype(np.uint8)
    syn = (errors @ Hd.T % 2).astype(np.uint8)
    out = dec.decode_batch(syn)
    assert np.array_equal((out @ Hd.T) % 2, syn)
    assert (~dec.converge_batch).any()  # the UF path actually exercised
    packed = np.packbits(syn, axis=1, bitorder="little")
    got = dec.decode_batch(packed, bit_packed_syndromes=True, bit_packed_output=True)
    assert (got == np.packbits(out, axis=1, bitorder="little")).all()


def test_belief_find_validation():
    D = functools.partial(ldpc_tpu_torch.BeliefFindDecoder, device="cpu")
    with pytest.raises(ValueError, match="point like"):
        D(hamming_code(3), error_rate=0.1, uf_method="peeling")
    with pytest.raises(ValueError, match="Invalid UF method"):
        D(rep_code(5), error_rate=0.1, uf_method="nonsense")
    dec = D(rep_code(5), error_rate=0.1, uf_method="matrix")
    assert dec.uf_method == "inversion" and dec.bits_per_step == 5
    assert D(rep_code(5), error_rate=0.1, bits_per_step=2).bits_per_step == 2
    with pytest.raises(ValueError):
        dec.decode_batch(np.zeros((2, 5), np.uint8))


def test_belief_find_inversion_hamming_exhaustive():
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.BeliefFindDecoder(H, error_rate=0.1, max_iter=2, uf_method="inversion", device="cpu")
    syn = _all_syndromes(3)
    out = dec.decode_batch(syn)
    assert np.array_equal((out @ Hd.T) % 2, syn)


def test_belief_find_zero_syndrome():
    dec = ldpc_tpu_torch.BeliefFindDecoder(rep_code(5), error_rate=0.1, uf_method="peeling", device="cpu")
    x = dec.decode(np.zeros(4, np.uint8))
    assert not x.any() and dec.converge


def test_column_order_puts_every_nan_last():
    """The growth and column orders sort every NaN after +inf, whatever its
    sign bit (a NaN from ``log`` of a negative number has it set), as the
    JAX package's argsort and numpy's do; equal keys keep column order."""
    from ldpc_tpu_torch.ops import gf2

    neg_nan = -np.float64(np.nan)
    assert np.signbit(neg_nan)
    keys = np.array([[2.0, neg_nan, -np.inf, np.nan, 1.0, np.inf, neg_nan, 1.0]])
    want = np.asarray(jnp.argsort(jnp.asarray(keys), axis=1, stable=True))
    np.testing.assert_array_equal(want, np.argsort(keys, axis=1, kind="stable"))
    for dt in (torch.float32, torch.float64):
        got = gf2.column_order(torch.from_numpy(keys).to(dt))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tuf.llr_rank(torch.from_numpy(keys)).numpy()[0], np.argsort(want[0]))
