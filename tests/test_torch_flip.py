"""Flip and BpFlip in the port (ldpc_tpu_torch.ops.flip, FlipDecoder,
BpFlipDecoder) held against the JAX package, and ports of the JAX
package's tests/test_flip_decoder.py.

Syndromes are made with numpy from a seed and fed to both sides; the JAX
side runs on the CPU. On CPU tensors the port runs the flip sweep's plain
PyTorch version (tests/test_torch_kernels.py holds the CUDA kernel to it on
the card). Without p-flip both sides are deterministic and must be equal
exactly. With p-flip the coins differ by design (the port's is a hash of
(seed, lane, sweep, bit), JAX's is ``jax.random``), so those runs are held
by the sweep's invariants instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, rep_code, ring_code, surface_code
from ldpc_tpu.ops import flip as jflip
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import flip as tflip
from ldpc_tpu_torch.ops.pcm import graph_to_torch

torch.set_num_threads(1)

KW = dict(max_iter=30, bp_method="minimum_sum", ms_scaling_factor=0.625)


def _all_syndromes(m):
    return ((np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)


def _random_syndromes(H, B, p, seed):
    Hd = np.asarray(H.todense(), np.uint8)
    errors = (np.random.default_rng(seed).random((B, Hd.shape[1])) < p).astype(np.uint8)
    return (errors @ Hd.T % 2).astype(np.uint8)


CODES = {
    "rep10": lambda: (rep_code(10), _all_syndromes(9)),
    "hamming3": lambda: (hamming_code(3), _all_syndromes(3)),
    "surface5": lambda: (surface_code(5).hx, _random_syndromes(surface_code(5).hx, 256, 0.05, 3)),
}


@pytest.mark.parametrize("max_iter", [1, 4, "n"])
@pytest.mark.parametrize("code", list(CODES))
def test_flip_reference_matches_jax(code, max_iter):
    """The plain flip sweep against ``ldpc_tpu.ops.flip.make_flip_decoder``
    without p-flip: equal decodings, convergence flags and iterations."""
    H, syn = CODES[code]()
    graph = compile_pcm(H)
    iters = graph.n if max_iter == "n" else max_iter
    want = jflip.make_flip_decoder(graph, iters, 0)(jnp.asarray(syn), jax.random.key(0))
    got = tflip.make_flip_decoder(graph, iters, 0, device="cpu")(torch.from_numpy(syn), 123)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    for a, b in zip(got, want):
        assert (a.numpy() == np.asarray(b)).all()
    conv = got[1].numpy()
    assert ((got[0].numpy() @ graph.dense.T % 2)[conv] == syn[conv]).all()


GROUPS = [1, 8, 32]


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("code", list(CODES))
def test_flip_scan_reference_matches_plain_version_and_jax(code, group):
    """The plain model of the kernel's scan (``group`` bits decided at once,
    the first flip applied, the scan resumed after it) without p-flip: equal
    to the plain sweep and to ``ldpc_tpu.ops.flip.make_flip_decoder``."""
    H, syn = CODES[code]()
    graph = compile_pcm(H)
    tg = graph_to_torch(graph, "cpu")
    s = torch.from_numpy(syn)
    scan = tflip.flip_scan_reference(tg, s, graph.n, 0, 123, group)
    plain = tflip.flip_reference(tg, s, graph.n, 0, 123)
    want = jflip.make_flip_decoder(graph, graph.n, 0)(jnp.asarray(syn), jax.random.key(0))
    for a, b, c in zip(scan, plain, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert (a.numpy() == np.asarray(c)).all()


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("pfreq,max_iter", [(0, 41), (1, 6), (3, 12)])
def test_flip_scan_reference_matches_plain_version_with_pflip(pfreq, max_iter, group):
    """With p-flip both draw the hashed coin of (seed, lane, sweep, bit), so
    the scan equals the plain sweep bit for bit; lanes converge in the
    middle of a scan and of a sweep."""
    H = surface_code(5).hx
    graph = compile_pcm(H)
    tg = graph_to_torch(graph, "cpu")
    s = torch.from_numpy(_random_syndromes(H, 256, 0.08, 9))
    scan = tflip.flip_scan_reference(tg, s, max_iter, pfreq, 5, group)
    plain = tflip.flip_reference(tg, s, max_iter, pfreq, 5)
    for a, b in zip(scan, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    conv = plain[1].numpy()
    assert conv.any() and not conv.all()
    assert ((scan[0].numpy() @ graph.dense.T % 2)[conv] == s.numpy()[conv]).all()


def test_coin_is_the_integer_hash():
    """The coin on int64 tensors equals the same hash on Python ints, and is
    close to fair."""
    lanes = torch.arange(4096, dtype=torch.int64)
    flips = tflip.coin(0xDEADBEEF, lanes, 7, 311)
    assert flips.dtype == torch.bool
    for lane in (0, 1, 977, 4095):
        assert bool(flips[lane]) == tflip.coin(0xDEADBEEF, lane, 7, 311)
    assert 1900 < int(flips.sum()) < 2200
    # lowbias32 with products taken mod 2**32 by Python's integers
    assert tflip._mix32(0) == 0
    assert tflip._mix32(1) == 0x688990C0
    assert tflip._mix32(0xDEADBEEF) == 0xE628C683


@pytest.mark.parametrize("pfreq", [1, 3])
def test_pflip_invariants(pfreq):
    """With p-flip: converged rows reproduce their syndrome and report a
    sweep in 1..max_iter, the others report max_iter; the same seed gives
    the same result, and row results do not depend on the batch's other
    rows."""
    H = surface_code(5).hx
    graph = compile_pcm(H)
    syn = _random_syndromes(H, 256, 0.08, 9)
    dec_fn = tflip.make_flip_decoder(graph, 12, pfreq, device="cpu")
    dec, conv, iters = (t.numpy() for t in dec_fn(torch.from_numpy(syn), 5))
    assert ((dec @ graph.dense.T % 2)[conv] == syn[conv]).all()
    zero = ~syn.any(axis=1)
    assert (iters[conv & ~zero] >= 1).all() and (iters[conv] <= 12).all()
    assert (iters[~conv] == 12).all() and (iters[zero] == 0).all()
    again = dec_fn(torch.from_numpy(syn), 5)
    assert (again[0].numpy() == dec).all() and (again[2].numpy() == iters).all()
    head = dec_fn(torch.from_numpy(syn[:100]), 5)
    assert (head[0].numpy() == dec[:100]).all()


def test_syndrome_of_is_h_times_x():
    H = surface_code(5).hx
    graph = compile_pcm(H)
    x = (np.random.default_rng(1).random((64, graph.n)) < 0.3).astype(np.uint8)
    got = tflip.syndrome_of(graph_to_torch(graph, "cpu"), torch.from_numpy(x))
    assert got.dtype == torch.uint8
    assert (got.numpy() == x @ graph.dense.T % 2).all()


def test_flip_decoder_matches_jax():
    H = surface_code(5).hx
    syn = _random_syndromes(H, 256, 0.05, 4)
    jd = ldpc_tpu.FlipDecoder(H, max_iter=0, seed=3)
    td = ldpc_tpu_torch.FlipDecoder(H, max_iter=0, seed=3, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert (got == want).all()
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    assert td.max_iter == H.shape[1] and td.converge == jd.converge
    assert td.iterations == jd.iterations and (td.decoding == jd.decoding).all()


@pytest.fixture(scope="module")
def d13():
    hx = surface_code(13).hx
    H = np.asarray(hx.todense(), np.uint8)
    syn = _random_syndromes(hx, 1024, 0.01, 7)
    syn[3] = 0  # a zero-syndrome row
    return hx, H, syn


@pytest.mark.parametrize("flip_iterations", [0, 2])
def test_bp_flip_decode_batch_matches_jax(d13, flip_iterations):
    """The slice end to end: ``BpFlipDecoder`` on 1,024 d=13 syndromes
    against the JAX decoder's CPU path, exactly; H x = s on converged rows."""
    hx, H, syn = d13
    kw = dict(error_rate=0.01, flip_iterations=flip_iterations, **KW)
    jd = ldpc_tpu.BpFlipDecoder(hx, **kw)
    td = ldpc_tpu_torch.BpFlipDecoder(hx, **kw, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert got.dtype == np.uint8 and (got == want).all()
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    conv = td.converge_batch
    assert ((got @ H.T) % 2 == syn)[conv].all()
    assert (~conv).any()  # some rows fail BP and keep their decodings
    assert td.converge == jd.converge and td.iter == jd.iter
    assert (td.decoding == want[0]).all() and not got[3].any()
    np.testing.assert_allclose(td.log_prob_ratios, np.asarray(jd.log_prob_ratios), rtol=1e-6)


# ----------------------------------------------------------------------
# ports of tests/test_flip_decoder.py
# ----------------------------------------------------------------------
def test_flip_rep_code_single_errors():
    """Weight-1 errors on a rep code flip back exactly."""
    H = rep_code(10)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.FlipDecoder(H, max_iter=20, seed=3, device="cpu")
    for j in range(10):
        e = np.zeros(10, np.uint8)
        e[j] = 1
        s = Hd @ e % 2
        x = dec.decode(s)
        if dec.converge:
            assert np.array_equal(Hd @ x % 2, s)


def test_flip_converged_solutions_reproduce_syndrome():
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.FlipDecoder(H, max_iter=50, pfreq=2, seed=42, device="cpu")
    syn = _all_syndromes(3)
    out = dec.decode_batch(syn)
    conv = dec.converge_batch
    assert conv.any()
    assert np.array_equal(((out @ Hd.T) % 2)[conv], syn[conv])


def test_flip_zero_syndrome():
    dec = ldpc_tpu_torch.FlipDecoder(rep_code(5), max_iter=10, device="cpu")
    x = dec.decode(np.zeros(4, np.uint8))
    assert not x.any()
    assert dec.converge and dec.iterations == 0


def test_flip_pfreq_helps_on_ties():
    """Ring codes have even-degree bits everywhere; plain flip stalls on
    tie configurations that p-flip escapes (arXiv:2212.06985)."""
    H = ring_code(9)
    Hd = np.asarray(H.todense(), np.uint8)
    rng = np.random.default_rng(5)
    errors = (rng.random((64, 9)) < 0.15).astype(np.uint8)
    syn = errors @ Hd.T % 2
    plain = ldpc_tpu_torch.FlipDecoder(H, max_iter=60, pfreq=0, seed=11, device="cpu")
    pflip = ldpc_tpu_torch.FlipDecoder(H, max_iter=60, pfreq=1, seed=11, device="cpu")
    plain.decode_batch(syn)
    pflip.decode_batch(syn)
    assert pflip.converge_batch.sum() >= plain.converge_batch.sum()
    assert pflip.converge_batch.sum() > plain.converge_batch.sum()
    # without p-flip the JAX package stalls on the same rows
    jplain = ldpc_tpu.FlipDecoder(H, max_iter=60, pfreq=0, seed=11)
    jplain.decode_batch(syn)
    assert (jplain.converge_batch == plain.converge_batch).all()


def test_flip_invalid_inputs():
    with pytest.raises(TypeError):
        ldpc_tpu_torch.FlipDecoder([[1, 0], [0, 1]], device="cpu")
    dec = ldpc_tpu_torch.FlipDecoder(rep_code(5), device="cpu")
    with pytest.raises(ValueError):
        dec.decode(np.zeros(7, np.uint8))


def test_bp_flip_decoder():
    H = rep_code(20)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.BpFlipDecoder(
        H, error_rate=0.1, max_iter=20, flip_iterations=5, pflip_seed=1, device="cpu"
    )
    rng = np.random.default_rng(0)
    errors = (rng.random((32, 20)) < 0.1).astype(np.uint8)
    syn = (errors @ Hd.T % 2).astype(np.uint8)
    out = dec.decode_batch(syn)
    assert dec.converge_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, syn)
    # zero syndrome short-circuit
    x = dec.decode(np.zeros(19, np.uint8))
    assert not x.any() and dec.converge
    with pytest.raises(ValueError):
        dec.decode(np.zeros(20, np.uint8))
