"""OSD-E/CS of the port (ldpc_tpu_torch.ops.osd, kernel K3') held against the
JAX package, and the plain versions of K3'-K5' against the Pallas kernels.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU, its Pallas kernels in interpret mode. On CPU tensors the
port runs each kernel's plain PyTorch version (tests/test_torch_kernels.py
holds the CUDA kernels against those on the card).

OSD-w ties: with a uniform channel many candidates weigh the same multiple
of log(1/p), and both packages pick the first float32 minimum, which
depends on summation order. A host sweep in float64
(:func:`_host_candidates`) finds each lane's minimum weight and how many
candidates reach it. Where one does, the decodings must be equal; on the
other ("tie") lanes the port's decoding must solve H x = s and weigh the
same as JAX's within 1e-5 relative (float64, on the host).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, surface_code
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops import gf2 as jgf2
from ldpc_tpu.ops import osd as josd
from ldpc_tpu.ops.gf2_pallas import (
    make_masked_export_solver,
    make_masked_solver,
    make_rref_export_solver,
)
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import gf2 as tgf2
from ldpc_tpu_torch.ops import gf2_cuda
from ldpc_tpu_torch.ops import osd as tosd
from ldpc_tpu_torch.ops.pcm import graph_to_torch

torch.set_num_threads(1)

KW = dict(max_iter=30, bp_method="minimum_sum", ms_scaling_factor=0.625)


def _workload(H, B, p, seed=11, iters=4):
    """Syndromes of BSC(p) errors and BP posteriors after ``iters``
    iterations, so each lane has its own column order."""
    graph = compile_pcm(H)
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, graph.n)) < p).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llr0 = jbp.channel_llr(np.full(graph.n, p))
    bp = jbp.make_parallel_decoder(graph, jbp.MINIMUM_SUM, iters, 0.625)
    llrs = np.array(bp(jnp.asarray(syn), jnp.asarray(llr0)).llr_posterior)
    return graph, syn, llrs


@pytest.fixture(scope="module")
def small():
    return {
        "surface3": _workload(surface_code(3).hx, 128, 0.08),
        "surface5": _workload(surface_code(5).hx, 128, 0.08),
    }


def _order(llrs):
    return torch.argsort(torch.from_numpy(llrs), dim=1, stable=True).to(torch.int32)


def _counts(n, B, seed=5):
    counts = np.random.default_rng(seed).integers(0, n + 1, B).astype(np.int32)
    counts[:3] = [0, n, 1]
    return counts


def _assert_export_matches(graph, port, jax_out):
    words, col_of_row, used = port
    R, synd_red, colrow_j, used_j = (np.asarray(a) for a in jax_out)
    bits = tgf2.unpack_u32(words, graph.n + 1).numpy()
    assert words.dtype == torch.int32 and col_of_row.dtype == torch.int32
    assert (bits[:, :, : graph.n] == R).all()
    assert (bits[:, :, graph.n] == synd_red).all()
    assert (col_of_row.numpy() == colrow_j).all()
    assert (used.numpy() == used_j).all()


@pytest.mark.parametrize("name", ["surface3", "surface5"])
def test_rref_export_reference_matches_pallas(small, name):
    """K3's plain version against ``_rref_export_kernel`` in interpret mode:
    bit-identical R, reduced syndrome, pivot columns and used rows."""
    graph, syn, llrs = small[name]
    rank = jgf2.batched_rank(graph.dense)
    want = make_rref_export_solver(graph, interpret=True)(
        jnp.asarray(syn), jnp.asarray(llrs)
    )
    got = gf2_cuda.rref_export_reference(
        graph_to_torch(graph, "cpu"), torch.from_numpy(syn), _order(llrs), rank
    )
    _assert_export_matches(graph, got, want)
    assert (got[2].sum(dim=1) == rank).all()


@pytest.mark.parametrize("name", ["surface3", "surface5"])
def test_masked_solve_reference_matches_pallas(small, name):
    """K4's plain version against ``_masked_solve_kernel``: bit-identical x0
    and bad rows, with per-lane counts from 0 to n."""
    graph, syn, llrs = small[name]
    order, counts = _order(llrs), _counts(graph.n, syn.shape[0])
    x0_j, bad_j = make_masked_solver(graph, interpret=True)(
        jnp.asarray(syn), jnp.asarray(order.numpy()), jnp.asarray(counts)
    )
    x0, bad = gf2_cuda.masked_solve_reference(
        graph_to_torch(graph, "cpu"), torch.from_numpy(syn), order, torch.from_numpy(counts)
    )
    assert x0.dtype == torch.uint8 and bad.dtype == torch.bool
    assert (x0.numpy() == np.asarray(x0_j)).all()
    assert (bad.numpy() == np.asarray(bad_j)).all()
    assert (bad.numpy()[0] == syn[0]).all()  # count 0: every syndrome row is bad


@pytest.mark.parametrize("name", ["surface3", "surface5"])
def test_masked_export_reference_matches_pallas(small, name):
    """K5's plain version against ``_masked_export_kernel``."""
    graph, syn, llrs = small[name]
    order, counts = _order(llrs), _counts(graph.n, syn.shape[0], seed=6)
    want = make_masked_export_solver(graph, interpret=True)(
        jnp.asarray(syn), jnp.asarray(order.numpy()), jnp.asarray(counts)
    )
    got = gf2_cuda.masked_export_reference(
        graph_to_torch(graph, "cpu"), torch.from_numpy(syn), order, torch.from_numpy(counts)
    )
    _assert_export_matches(graph, got, want)


def test_elimination_dispatch_on_cpu(small):
    """On CPU tensors every wrapper runs its plain version and launches
    nothing; the CUDA entry points refuse CPU tensors."""
    graph, syn, llrs = small["surface3"]
    tg = graph_to_torch(graph, "cpu")
    s, order = torch.from_numpy(syn), _order(llrs)
    counts = torch.from_numpy(_counts(graph.n, syn.shape[0]))
    rank = tgf2.batched_rank(graph.dense)
    before = {k: dict(v) for k, v in gf2_cuda.VARIANT_LAUNCHES.items()}
    pairs = [
        (gf2_cuda.rref_export, gf2_cuda.rref_export_reference, gf2_cuda.rref_export_cuda, rank),
        (gf2_cuda.masked_solve, gf2_cuda.masked_solve_reference, gf2_cuda.masked_solve_cuda, counts),
        (gf2_cuda.masked_export, gf2_cuda.masked_export_reference, gf2_cuda.masked_export_cuda, counts),
    ]
    for fn, ref, cuda, arg in pairs:
        for a, b in zip(fn(tg, s, order, arg), ref(tg, s, order, arg)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="CUDA"):
            cuda(tg, s, order, arg)
        with pytest.raises(ValueError, match="no kernel"):
            fn(tg, s.to("meta"), order, arg)
    assert before == gf2_cuda.VARIANT_LAUNCHES


@pytest.mark.parametrize("k", [0, 1, 4, 9])
@pytest.mark.parametrize("method,order", [(1, 0), (1, 3), (2, 0), (2, 3), (2, 6)])
def test_candidate_strings_match_jax(method, order, k):
    got = tosd.candidate_strings(method, order, k)
    want = josd.candidate_strings(method, order, k)
    assert got.shape == want.shape and (got == want).all()


def _host_candidates(H, s, llr, weights, method, order):
    """Every OSD-w candidate of one lane, in the reference's enumeration
    order, by Gauss-Jordan on the host: ((C, n) solutions, (C,) float64
    weights)."""
    m, n = H.shape
    cols = np.argsort(llr, kind="stable")
    A = np.concatenate([H[:, cols], s[:, None]], axis=1).astype(np.uint8)
    used = np.zeros(m, bool)
    piv = []  # (permuted column, row)
    for j in range(n):
        cand = np.flatnonzero(A[:, j].astype(bool) & ~used)
        if cand.size:
            r = cand[0]
            others = np.flatnonzero(A[:, j])
            others = others[others != r]
            A[others] ^= A[r]
            used[r] = True
            piv.append((j, r))
    pj = np.array([j for j, _ in piv], dtype=np.int64)
    pr = np.array([r for _, r in piv], dtype=np.int64)
    nonpiv = np.setdiff1d(np.arange(n), pj)  # ascending = least reliable first
    W = min(order, nonpiv.size)
    if method == tosd.EXHAUSTIVE:
        flips = [[]] + [[t for t in range(W) if (i >> t) & 1] for i in range(1, 2**W)]
    else:
        flips = [[]] + [[t] for t in range(nonpiv.size)]
        flips += [[a, b] for a in range(W) for b in range(a + 1, W)]
    sols = np.zeros((len(flips), n), np.uint8)
    for c, f in enumerate(flips):
        y = A[:, n] ^ (A[:, nonpiv[f]].sum(axis=1) % 2).astype(np.uint8)
        sols[c, cols[pj]] = y[pr]
        sols[c, cols[nonpiv[f]]] = 1
    return sols, sols.astype(np.float64) @ weights


def _assert_osdw_matches(H, syn, llrs, p, method, order, got, want):
    """Equal decodings on unique-minimum lanes; on tie lanes H x = s and
    the same float64 weight. Returns the number of tie lanes."""
    weights = np.full(H.shape[1], np.log(1.0 / p))
    ties = 0
    for b in range(syn.shape[0]):
        _, w = _host_candidates(H, syn[b], llrs[b], weights, method, order)
        low = w.min()
        if np.count_nonzero(w <= low * (1 + 1e-9)) == 1:
            assert (got[b] == want[b]).all(), b
            continue
        ties += 1
        assert ((H @ got[b]) % 2 == syn[b]).all(), b
        wg, ww = got[b] @ weights, want[b] @ weights
        assert abs(wg - ww) <= 1e-5 * ww, (b, wg, ww)
    return ties


OSD_CODES = {
    "hamming3": (lambda: hamming_code(3), 0.1, 64),
    "surface5": (lambda: surface_code(5).hx, 0.05, 192),
}


@pytest.mark.parametrize(
    "method,order",
    [(tosd.COMBINATION_SWEEP, 2), (tosd.COMBINATION_SWEEP, 5), (tosd.EXHAUSTIVE, 2), (tosd.EXHAUSTIVE, 4)],
    ids=["cs2", "cs5", "e2", "e4"],
)
@pytest.mark.parametrize("name", list(OSD_CODES))
def test_osdw_matches_jax(name, method, order):
    """The port's OSD-w against ``make_osd_sweep_tpu`` (interpret mode) and
    ``make_osd_decoder`` on the same (syndrome, llr) pairs."""
    build, p, B = OSD_CODES[name]
    graph, syn, llrs = _workload(build(), B, p, seed=7, iters=5)
    channel = np.full(graph.n, p)
    args = (jnp.asarray(syn), jnp.asarray(llrs))
    s0, sw, sv = josd.make_osd_sweep_tpu(graph, channel, method, order, interpret=True)(*args)
    x0, xw, xv = josd.make_osd_decoder(graph, channel, method, order)(*args)
    t0, tw, tv = tosd.make_osd_decoder(graph, channel, method, order, "cpu")(
        torch.from_numpy(syn), torch.from_numpy(llrs)
    )
    assert t0.dtype == tw.dtype == torch.uint8 and tv.dtype == torch.bool
    # OSD-0 and validity are GF(2) results: exact
    assert (t0.numpy() == np.asarray(s0)).all() and (t0.numpy() == np.asarray(x0)).all()
    assert (tv.numpy() == np.asarray(sv)).all() and (tv.numpy() == np.asarray(xv)).all()
    H = graph.dense
    got = tw.numpy()
    for want in (np.asarray(sw), np.asarray(xw)):
        _assert_osdw_matches(H, syn, llrs, p, method, order, got, want)
    assert ((got @ H.T) % 2 == syn).all()
    # a higher order never weighs more than OSD-0
    assert (got.sum(axis=1) <= t0.numpy().sum(axis=1)).all()


def test_osdw_chunks_are_independent():
    """The sweep's lane chunks change nothing: one lane at a time decodes
    as the whole batch does."""
    graph, syn, llrs = _workload(surface_code(5).hx, 24, 0.08)
    channel = np.full(graph.n, 0.08)
    dec = tosd.make_osd_decoder(graph, channel, tosd.COMBINATION_SWEEP, 4, "cpu")
    whole = dec(torch.from_numpy(syn), torch.from_numpy(llrs))
    for b in range(0, 24, 7):
        one = dec(torch.from_numpy(syn[b : b + 1]), torch.from_numpy(llrs[b : b + 1]))
        for a, w in zip(one, whole):
            assert torch.equal(a[0], w[b])


@pytest.fixture(scope="module")
def d13():
    hx = surface_code(13).hx
    H = np.asarray(hx.todense(), np.uint8)
    rng = np.random.default_rng(7)
    errors = (rng.random((1024, H.shape[1])) < 0.01).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    syn[3] = 0  # a zero-syndrome row
    return hx, H, syn


def test_bposd_cs5_decode_batch_matches_jax(d13):
    """The slice end to end: ``BpOsdDecoder(osd_cs, 5)`` on 1,024 d=13
    syndromes, against the JAX decoder."""
    hx, H, syn = d13
    kw = dict(error_rate=0.01, osd_method="osd_cs", osd_order=5, **KW)
    jd = ldpc_tpu.BpOsdDecoder(hx, **kw)
    td = ldpc_tpu_torch.BpOsdDecoder(hx, **kw, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    assert ((got @ H.T) % 2 == syn).all()
    assert (td.osd0_decoding_batch == np.asarray(jd.osd0_decoding_batch)).all()
    failed = np.flatnonzero(~td.converge_batch)
    assert failed.size > 50
    assert (got[td.converge_batch] == want[td.converge_batch]).all()
    llrs = td.log_prob_ratios_batch[failed]
    ties = _assert_osdw_matches(H, syn[failed], llrs, 0.01, tosd.COMBINATION_SWEEP, 5,
                                got[failed], want[failed])
    assert ties < failed.size
    # OSD-w and OSD-0 are distinct at order 5, and CS never weighs more
    assert (td.osdw_decoding_batch == got).all()
    assert (td.osd0_decoding_batch != got).any()
    assert (got.sum(axis=1) <= td.osd0_decoding_batch.sum(axis=1)).all()


def test_cascade_keeps_the_osd0_output(d13):
    """The cascade, now shared by both post-processing decoders, gives
    BpOsdDecoder's OSD-0 output as before: one full-depth BP run, then
    OSD-0 on exactly the lanes it fails, zeros on zero syndromes."""
    hx, H, syn = d13
    td = ldpc_tpu_torch.BpOsdDecoder(hx, error_rate=0.01, osd_method="osd_0", **KW, device="cpu")
    got = td.decode_batch(syn)
    bd = ldpc_tpu_torch.BpDecoder(hx, error_rate=0.01, **KW, device="cpu")
    bp_out = bd.decode_batch(syn)
    want = bp_out.copy()
    failed = np.flatnonzero(~bd.converge_batch & syn.any(axis=1))
    osd = tosd.make_osd_decoder(compile_pcm(hx), np.full(H.shape[1], 0.01), tosd.OSD_0, 0, "cpu")
    x0, _, _ = osd(torch.from_numpy(syn[failed]), torch.from_numpy(bd.log_prob_ratios_batch[failed]))
    want[failed] = x0.numpy()
    want[~syn.any(axis=1)] = 0
    assert (got == want).all()
    assert (td.osd0_decoding_batch == got).all() and (td.osdw_decoding_batch == got).all()
    nz = syn.any(axis=1)
    assert (td.bp_decoding_batch[nz] == bp_out[nz]).all()


def test_large_code_toric31_matches_jax():
    """A code whose packed [H | s] (238,328 bytes a lane) does not fit one
    block's shared memory on the card: toric d=31, 12 syndromes at p=0.03
    made with numpy from a seed. ``BpOsdDecoder`` (``osd_0``) and
    ``BpLsdDecoder`` on ``device="cpu"`` equal the JAX decoders, which
    decode such a code on their XLA engine, and every row satisfies
    H x = s. The card's path is held to the CPU path on the same code."""
    from ldpc_tpu_torch.codes import toric_code

    hx = toric_code(31, compute_logicals=False).hx
    H = np.asarray(hx.todense(), np.uint8)
    assert (H.shape[0] * (H.shape[1] // 32 + 1) + H.shape[0]) * 4 > 232448
    errors = (np.random.default_rng(31).random((12, H.shape[1])) < 0.03).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    kw = dict(error_rate=0.03, **KW)
    for jax_cls, torch_cls, method in (
        (ldpc_tpu.BpOsdDecoder, ldpc_tpu_torch.BpOsdDecoder, dict(osd_method="osd_0")),
        (ldpc_tpu.BpLsdDecoder, ldpc_tpu_torch.BpLsdDecoder, dict(lsd_method="lsd_0")),
    ):
        jd = jax_cls(hx, **kw, **method)
        td = torch_cls(hx, **kw, **method, device="cpu")
        want = np.asarray(jd.decode_batch(syn))
        got = td.decode_batch(syn)
        assert not td.converge_batch.all()  # lanes reach the post-processor
        assert (got == want).all()
        assert ((got.astype(np.int64) @ H.T) % 2 == syn).all()
