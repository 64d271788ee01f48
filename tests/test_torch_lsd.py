"""LSD's ops in the port (ldpc_tpu_torch.ops.uf and ops.lsd; kernels K4'
and K5') held against the JAX package. tests/test_torch_bplsd.py holds the
decoder, BpLsdDecoder.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU (its Pallas kernels in interpret mode). On CPU tensors the
port runs each kernel's plain PyTorch version. LSD's candidate keys are
integers, so every result here must be equal, tie or not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldpc_tpu.codes import hamming_code, surface_code
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops import lsd as jlsd
from ldpc_tpu.ops import uf as juf
from ldpc_tpu.ops.gf2_pallas import make_masked_solver
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import gf2_cuda
from ldpc_tpu_torch.ops import lsd as tlsd
from ldpc_tpu_torch.ops import uf as tuf
from ldpc_tpu_torch.ops.pcm import graph_to_torch

torch.set_num_threads(1)

def _workload(H, B, p, seed=11, iters=4):
    graph = compile_pcm(H)
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, graph.n)) < p).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llr0 = jbp.channel_llr(np.full(graph.n, p))
    bp = jbp.make_parallel_decoder(graph, jbp.MINIMUM_SUM, iters, 0.625)
    llrs = np.array(bp(jnp.asarray(syn), jnp.asarray(llr0)).llr_posterior)
    return graph, syn, llrs


@pytest.fixture(scope="module")
def surface3():
    """tests/test_pallas_kernels.py's growth workload."""
    return _workload(surface_code(3).hx, 128, 0.08)


@pytest.fixture(scope="module")
def surface5():
    return _workload(surface_code(5).hx, 128, 0.06, seed=3)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("bits_per_step", [0, 1, 2])
def test_growth_matches_jax(surface3, bits_per_step):
    """The port's growth loop (K4' once per round) against the fused JAX
    loop with the interpret-mode masked solver and against the XLA engine:
    equal cluster membership, solutions and validity."""
    graph, syn, llrs = surface3
    B = syn.shape[0]
    solver = make_masked_solver(graph, interpret=True)
    in_f, x0_f, valid_f = juf.grow_until_valid_fast(
        graph, jnp.asarray(syn), jnp.asarray(llrs), bits_per_step, jnp.float32, solver
    )
    in_x, res, order = juf.grow_until_valid(
        graph, jnp.asarray(syn), jnp.asarray(llrs), bits_per_step, jnp.float32
    )
    dec_x = np.zeros((B, graph.n), np.uint8)
    dec_x[np.arange(B)[:, None], np.asarray(order)] = np.asarray(res.x0)
    in_t, x0_t, valid_t = tuf.grow_until_valid(
        graph_to_torch(graph, "cpu"), *_t(syn, llrs), bits_per_step
    )
    assert in_t.dtype == torch.bool and x0_t.dtype == torch.uint8
    for want_in, want_x0, want_valid in (
        (in_f, x0_f, valid_f),
        (in_x, dec_x, res.valid),
    ):
        assert (in_t.numpy() == np.asarray(want_in)).all()
        assert (x0_t.numpy() == np.asarray(want_x0)).all()
        assert (valid_t.numpy() == np.asarray(want_valid)).all()
    assert valid_t.all()
    assert ((x0_t.numpy() @ graph.dense.T) % 2 == syn).all()


@pytest.fixture(scope="module")
def grown(surface5):
    """A mid-growth cluster state of the surface d=5 workload (one growth
    round of the port, which test_growth_matches_jax holds to JAX's), with
    JAX's labels and the bad rows of its masked solve."""
    graph, syn, llrs = surface5
    tg = graph_to_torch(graph, "cpu")
    s, l = _t(syn, llrs)
    order = torch.argsort(l, dim=1, stable=True).to(torch.int32)
    none = torch.zeros(syn.shape[0], dtype=torch.int32)
    _, bad = gf2_cuda.masked_solve_reference(tg, s, order, none)
    in_bit, _ = tuf.grow_round(tg, torch.zeros_like(l, dtype=torch.bool), bad, tuf.llr_rank(l), 1)
    key = torch.where(in_bit, l, torch.inf)
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    _, bad = gf2_cuda.masked_solve_reference(tg, s, order, in_bit.sum(dim=1).to(torch.int32))
    seed = syn == 1
    labels, active = juf._propagate_labels(graph, jnp.asarray(in_bit.numpy()), jnp.asarray(seed))
    return graph, in_bit.numpy(), seed, np.asarray(labels), np.asarray(active), bad.numpy()


def test_propagate_labels_matches_jax(grown):
    graph, in_bit, seed, labels, active, _ = grown
    got, active_t = tuf.propagate_labels(graph_to_torch(graph, "cpu"), *_t(in_bit, seed))
    assert (active_t.numpy() == active).all()
    assert (got.numpy() == labels.astype(np.int64)).all()
    # a warm start from the same fixpoint changes nothing
    warm, _ = tuf.propagate_labels(graph_to_torch(graph, "cpu"), *_t(in_bit, seed), warm=got)
    assert torch.equal(warm, got)


def test_invalid_checks_from_bad_matches_jax(grown):
    graph, _, _, labels, _, bad = grown
    want = juf.invalid_checks_from_bad(jnp.asarray(bad), jnp.asarray(labels), graph.m)
    got = tuf.invalid_checks_from_bad(*_t(bad, labels.astype(np.int64)), graph.m)
    assert (got.numpy() == np.asarray(want)).all()
    assert got.any()


@pytest.mark.parametrize("bits_per_step", [0, 1, 3])
def test_grow_round_matches_jax(surface5, grown, bits_per_step):
    """One growth round against ``_grow_round_mm`` on the same bad rows."""
    graph, syn, llrs = surface5
    _, in_bit, _, _, _, bad = grown
    rank = np.argsort(np.argsort(llrs, axis=1, kind="stable"), axis=1, kind="stable")
    want_in, want_any = juf._grow_round_mm(
        graph, juf._adj_constants(graph), in_bit, jnp.asarray(bad),
        jnp.asarray(rank.astype(np.float32)), bits_per_step,
    )
    assert (tuf.llr_rank(torch.from_numpy(llrs)).numpy() == rank).all()
    got_in, got_any = tuf.grow_round(
        graph_to_torch(graph, "cpu"), *_t(in_bit, bad, rank), bits_per_step
    )
    assert (got_in.numpy() == np.asarray(want_in)).all()
    assert (got_any.numpy() == np.asarray(want_any)).all()


def _all_syndromes(m):
    return ((np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)


LSD_CONFIGS = [(tlsd.LSD_0, 0), (tlsd.LSD_CS, 3), (tlsd.LSD_E, 3)]
LSD_IDS = ["lsd0", "lsd_cs3", "lsd_e3"]


@pytest.mark.parametrize("method,order", LSD_CONFIGS, ids=LSD_IDS)
@pytest.mark.parametrize("code", ["hamming3", "surface5"])
def test_make_lsd_decoder_matches_jax(request, code, method, order):
    """Equal decodings and validity: every syndrome of the [7,4] Hamming
    code (weights 0.3 + 0.1 j, as the JAX package's exhaustive sweep), and
    BP posteriors on surface d=5."""
    if code == "hamming3":
        H = hamming_code(3)
        graph = compile_pcm(H)
        syn = _all_syndromes(graph.m)
        llrs = np.tile(0.3 + 0.1 * np.arange(graph.n, dtype=np.float32), (syn.shape[0], 1))
    else:
        graph, syn, llrs = request.getfixturevalue("surface5")
    want, valid_j = jlsd.make_lsd_decoder(graph, method, order, 1)(
        jnp.asarray(syn), jnp.asarray(llrs)
    )
    got, valid_t = tlsd.make_lsd_decoder(graph, method, order, 1, "cpu")(*_t(syn, llrs))
    assert got.dtype == torch.uint8 and valid_t.dtype == torch.bool
    assert (got.numpy() == np.asarray(want)).all()
    assert (valid_t.numpy() == np.asarray(valid_j)).all()
    assert valid_t.all()
    assert ((got.numpy() @ graph.dense.T) % 2 == syn).all()


def test_lsdw_grow_all(surface5):
    """Order w when every boundary bit joins: ``bits_per_step`` 0, and n or
    more, which means the same; the decodings are valid."""
    graph, syn, llrs = surface5
    got = [
        tlsd.make_lsd_decoder(graph, tlsd.LSD_CS, 4, bits_per_step, "cpu")(*_t(syn, llrs))[0]
        for bits_per_step in (0, graph.n, graph.n + 5)
    ]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    assert ((got[0].numpy() @ graph.dense.T) % 2 == syn).all()


def test_lsdw_not_heavier_than_lsd0():
    """Higher-order candidates may only lower the solution weight (the JAX
    package's test_lsdw_not_heavier_than_lsd0, on make_lsd_decoder)."""
    code = surface_code(5)
    graph = compile_pcm(code.hx)
    rng = np.random.default_rng(3)
    errors = (rng.random((64, graph.n)) < 0.08).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llrs = np.tile((rng.random(graph.n) + 0.5).astype(np.float32), (64, 1))
    d0, _ = tlsd.make_lsd_decoder(graph, tlsd.LSD_0, 0, 1, "cpu")(*_t(syn, llrs))
    d5, _ = tlsd.make_lsd_decoder(graph, tlsd.LSD_CS, 5, 1, "cpu")(*_t(syn, llrs))
    out0, out5 = d0.numpy(), d5.numpy()
    assert ((out0 @ graph.dense.T) % 2 == syn).all()
    assert ((out5 @ graph.dense.T) % 2 == syn).all()
    assert (out5.sum(axis=1) <= out0.sum(axis=1)).all()
    assert (out5.sum(axis=1) < out0.sum(axis=1)).any()
