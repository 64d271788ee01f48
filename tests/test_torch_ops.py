"""The port's ops layer (ldpc_tpu_torch.ops) held against the JAX package.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU. On CPU tensors the port runs each kernel's plain PyTorch
version, so these tests hold the algorithms; tests/test_torch_kernels.py
holds the CUDA kernels against those plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldpc_tpu.codes import hamming_code, surface_code, toric_code
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops import gf2 as jgf2
from ldpc_tpu.ops import osd as josd
from ldpc_tpu.ops.gf2_pallas import make_osd0_solver
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.ops import bp as tbp
from ldpc_tpu_torch.ops import bp_cuda, gf2_cuda
from ldpc_tpu_torch.ops import gf2 as tgf2
from ldpc_tpu_torch.ops import osd as tosd
from ldpc_tpu_torch.ops.pcm import graph_to_torch
from ldpc_tpu_torch.utils import profiling as pf

torch.set_num_threads(1)

# (name, pcm builder, error rate, batch)
CODES = {
    "surface3": (lambda: surface_code(3).hx, 0.05, 128),
    "surface5": (lambda: surface_code(5).hx, 0.05, 256),
    "hamming3": (lambda: hamming_code(3), 0.1, 64),
    "surface13": (lambda: surface_code(13).hx, 0.01, 512),
}


def _workload(name):
    build, p, B = CODES[name]
    graph = compile_pcm(build())
    rng = np.random.default_rng(7)
    errors = (rng.random((B, graph.n)) < p).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llr = jbp.channel_llr(np.full(graph.n, p))
    return graph, syn, llr, p


@pytest.fixture(scope="module")
def workloads():
    return {name: _workload(name) for name in CODES}


@pytest.mark.parametrize("name", ["surface3", "hamming3", "surface13"])
def test_graph_to_torch_round_trips_compile_pcm(workloads, name):
    graph = workloads[name][0]
    tg = graph_to_torch(graph, "cpu")
    assert (tg.m, tg.n, tg.dc, tg.dv) == (graph.m, graph.n, graph.dc, graph.dv)
    assert tg.num_edges == graph.num_edges
    assert (tg.chk_bits.numpy() == graph.chk_bits).all()
    assert (tg.chk_mask.numpy() == graph.chk_mask).all()
    assert (tg.var_edges.numpy() == graph.var_edges).all()
    assert (tg.var_chks.numpy() == graph.var_chks).all()
    assert (tg.var_mask.numpy() == graph.var_mask).all()
    assert (tg.dense.numpy() == graph.dense).all()
    assert tg.chk_bits.dtype == tg.var_edges.dtype == tg.var_chks.dtype == torch.int32
    # pad conventions: chk_bits pad = n, var_edges pad = m*dc
    assert (tg.chk_bits.numpy()[~graph.chk_mask] == graph.n).all()
    assert (tg.var_edges.numpy()[~graph.var_mask] == graph.num_edges).all()
    assert (tg.var_chks.numpy()[~graph.var_mask] == graph.m).all()
    aug = np.concatenate([graph.dense, np.zeros((graph.m, 1), np.uint8)], axis=1)
    want = np.asarray(jgf2.pack_u32(jnp.asarray(aug)))
    assert tg.packed.shape == (graph.m, -(-(graph.n + 1) // 32))
    assert (tg.packed.numpy().view(np.uint32) == want).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 77, 313])
def test_pack_u32_matches_jax(n):
    bits = np.random.default_rng(n).integers(0, 2, (6, n)).astype(np.uint8)
    bits[0] = 1  # bit 31 set: the int32 pattern is negative
    want = np.asarray(jgf2.pack_u32(jnp.asarray(bits)))
    got = tgf2.pack_u32(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert (got.numpy().view(np.uint32) == want).all()
    back = tgf2.unpack_u32(got, n).numpy()
    assert (back == np.asarray(jgf2.unpack_u32(jnp.asarray(want), n))).all()
    assert (back == bits).all()


@pytest.mark.parametrize("n", [1, 8, 13, 156, 313])
def test_pack_bits_u8_matches_jax(n):
    bits = np.random.default_rng(n).integers(0, 2, (5, n)).astype(np.uint8)
    want = np.asarray(jgf2.pack_bits_u8(jnp.asarray(bits)))
    got = tgf2.pack_bits_u8(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    assert (got.numpy() == want).all()
    assert (tgf2.unpack_bits_u8(want, n) == jgf2.unpack_bits_u8(want, n)).all()
    dev = tgf2.unpack_bits_u8_device(torch.tensor(want), n).numpy()
    assert (dev == np.asarray(jgf2.unpack_bits_u8_device(jnp.asarray(want), n))).all()
    assert (dev == bits).all()


@pytest.mark.parametrize("name", ["surface5", "hamming3", "surface13"])
def test_batched_rank_matches_jax(workloads, name):
    dense = workloads[name][0].dense
    assert tgf2.batched_rank(dense) == jgf2.batched_rank(dense)


def test_channel_llr_matches_jax():
    p = np.array([0.0, 1e-3, 0.01, 0.1, 0.5, 0.9])
    want = jbp.channel_llr(p)
    got = tbp.channel_llr(p)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


BP_CONFIGS = {
    "ms0.625": (tbp.MINIMUM_SUM, 0.625),
    "ms_dynamic": (tbp.MINIMUM_SUM, 0.0),
    "product_sum": (tbp.PRODUCT_SUM, 1.0),
}


def _run_both(graph, syn, llr, method, alpha, max_iter):
    rj = jbp.make_parallel_decoder(graph, method, max_iter, alpha)(
        jnp.asarray(syn), jnp.asarray(llr)
    )
    rt = tbp.make_parallel_decoder(graph, method, max_iter, alpha, "cpu")(
        torch.from_numpy(syn), torch.from_numpy(llr)
    )
    return rj, rt


@pytest.mark.parametrize("config", list(BP_CONFIGS))
@pytest.mark.parametrize("name", list(CODES))
def test_bp_reference_matches_jax(workloads, name, config):
    """Flags, iteration counts and decisions exact. Min-sum posteriors
    within 1e-6 (XLA may associate the bit-side sum differently when
    dv > 2). Product-sum posteriors within 1e-3 on the small codes only:
    XLA's f32 tanh is a rational approximation up to ~4 ulp from torch's,
    and near the 1 - 1e-7 clip one ulp of the tanh product moves a message
    by up to log 2, so at d=13 saturated lanes differ by O(1) after 30
    iterations (their decisions still agree); there the one-iteration
    posteriors are held to 1e-5 instead."""
    graph, syn, llr, _ = workloads[name]
    method, alpha = BP_CONFIGS[config]
    rj, rt = _run_both(graph, syn, llr, method, alpha, 30)
    assert rt.decoding.dtype == torch.uint8
    assert rt.decoding.shape == (syn.shape[0], graph.n)
    assert (rt.converged.numpy() == np.asarray(rj.converged)).all()
    assert (rt.iterations.numpy() == np.asarray(rj.iterations)).all()
    assert (rt.decoding.numpy() == np.asarray(rj.decoding)).all()
    lj, lt = np.asarray(rj.llr_posterior), rt.llr_posterior.numpy()
    if method == tbp.MINIMUM_SUM:
        np.testing.assert_allclose(lt, lj, rtol=1e-6, atol=1e-6)
    elif name != "surface13":
        np.testing.assert_allclose(lt, lj, rtol=1e-3, atol=1e-3)
    else:
        rj1, rt1 = _run_both(graph, syn, llr, method, alpha, 1)
        np.testing.assert_allclose(
            rt1.llr_posterior.numpy(), np.asarray(rj1.llr_posterior),
            rtol=1e-5, atol=1e-5,
        )


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_bp_reference_short_runs_match_jax(workloads, max_iter):
    graph, syn, llr, _ = workloads["surface5"]
    rj, rt = _run_both(graph, syn, llr, tbp.MINIMUM_SUM, 0.625, max_iter)
    assert (rt.converged.numpy() == np.asarray(rj.converged)).all()
    assert (rt.iterations.numpy() == np.asarray(rj.iterations)).all()
    assert (rt.decoding.numpy() == np.asarray(rj.decoding)).all()
    np.testing.assert_array_equal(rt.llr_posterior.numpy(), np.asarray(rj.llr_posterior))


def test_bp_dispatch_runs_plain_version_on_cpu(workloads):
    graph, syn, llr, _ = workloads["surface3"]
    tg = graph_to_torch(graph, "cpu")
    s, l0 = torch.from_numpy(syn), torch.from_numpy(llr)
    pf.drain()
    pf.record(True)
    try:
        a = bp_cuda.bp_parallel(tg, s, l0, tbp.MINIMUM_SUM, 8, 0.625)
        b = bp_cuda.bp_parallel_reference(tg, s, l0, tbp.MINIMUM_SUM, 8, 0.625)
    finally:
        pf.record(False)
    assert pf.drain().counters == {}  # no kernel on the CPU
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        bp_cuda.bp_parallel_cuda(tg, s, l0, tbp.MINIMUM_SUM, 8, 0.625)
    with pytest.raises(ValueError, match="no kernel"):
        bp_cuda.bp_parallel(tg, s.to("meta"), l0, tbp.MINIMUM_SUM, 8, 0.625)


def _posteriors(graph, syn, llr):
    xfn = jbp.make_parallel_decoder(graph, jbp.MINIMUM_SUM, 5, 0.625)
    return np.array(xfn(jnp.asarray(syn), jnp.asarray(llr)).llr_posterior)


@pytest.mark.parametrize("name", ["surface3", "surface5", "hamming3", "surface13"])
def test_osd0_reference_matches_jax(workloads, name):
    """OSD-0 on the same (syndrome, llr) pairs: bit-identical to the XLA
    engine and to the Pallas kernel run in interpret mode."""
    graph, syn, llr, p = workloads[name]
    llrs = _posteriors(graph, syn, llr)
    d0, _, v = josd.make_osd_decoder(graph, np.full(graph.n, p), josd.OSD_0, 0)(
        jnp.asarray(syn), jnp.asarray(llrs)
    )
    x0, xw, valid = tosd.make_osd_decoder(
        graph, np.full(graph.n, p), tosd.OSD_0, 0, "cpu"
    )(torch.from_numpy(syn), torch.from_numpy(llrs))
    assert x0.dtype == torch.uint8 and valid.dtype == torch.bool
    assert (x0.numpy() == np.asarray(d0)).all()
    assert (xw.numpy() == x0.numpy()).all()
    assert (valid.numpy() == np.asarray(v)).all()
    ok = ((x0.numpy() @ graph.dense.T) % 2 == syn).all(axis=1)
    assert ok[valid.numpy()].all()
    if name != "surface13":  # interpret mode is slow at d=13
        xp, vp = make_osd0_solver(graph, interpret=True)(
            jnp.asarray(syn), jnp.asarray(llrs)
        )
        assert (x0.numpy() == np.asarray(xp)).all()
        assert (valid.numpy() == np.asarray(vp)).all()


def test_osd0_reports_out_of_image_syndromes():
    """A syndrome outside H's image is invalid on both sides, with the same
    partial solution."""
    H = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 0], [0, 0, 0, 1]], np.uint8)
    graph = compile_pcm(H)
    syn = np.array([[1, 0, 0, 0], [1, 1, 0, 1], [0, 0, 0, 0], [1, 1, 0, 0]], np.uint8)
    llrs = np.random.default_rng(3).random((4, 4)).astype(np.float32)
    d0, _, v = josd.make_osd_decoder(graph, np.full(4, 0.1), josd.OSD_0, 0)(
        jnp.asarray(syn), jnp.asarray(llrs)
    )
    x0, _, valid = tosd.make_osd_decoder(graph, np.full(4, 0.1), tosd.OSD_0, 0, "cpu")(
        torch.from_numpy(syn), torch.from_numpy(llrs)
    )
    assert (valid.numpy() == np.asarray(v)).all()
    assert not valid.numpy().all()
    assert (x0.numpy() == np.asarray(d0)).all()


def test_osd0_dispatch_and_higher_orders(workloads):
    graph, syn, llr, p = workloads["surface3"]
    tg = graph_to_torch(graph, "cpu")
    rank = tgf2.batched_rank(graph.dense)
    llrs = torch.from_numpy(_posteriors(graph, syn, llr))
    order = torch.argsort(llrs, dim=1, stable=True).to(torch.int32)
    s = torch.from_numpy(syn)
    pf.drain()
    pf.record(True)
    try:
        a = gf2_cuda.osd0(tg, s, order, rank)
        b = gf2_cuda.osd0_reference(tg, s, order, rank)
    finally:
        pf.record(False)
    assert pf.drain().counters == {}  # no kernel on the CPU
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="CUDA"):
        gf2_cuda.osd0_cuda(tg, s, order, rank)
    # higher orders run the sweep; order 0 of a higher method is plain
    # OSD-0, as in the JAX package
    x0, xw, _ = tosd.make_osd_decoder(
        graph, np.full(graph.n, p), tosd.COMBINATION_SWEEP, 2, "cpu"
    )(s, llrs)
    assert torch.equal(x0, a[0])
    assert ((xw.numpy() @ graph.dense.T) % 2 == syn).all()
    e0, ew, _ = tosd.make_osd_decoder(
        graph, np.full(graph.n, p), tosd.EXHAUSTIVE, 0, "cpu"
    )(s, llrs)
    assert torch.equal(e0, a[0]) and ew is e0


def test_osd0_toric20_no_size_cliff():
    """n=800 (toric d=20) runs through the same elimination."""
    code = toric_code(20)
    graph = compile_pcm(code.hx)
    rng = np.random.default_rng(7)
    errors = (rng.random((16, graph.n)) < 0.02).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llrs = rng.standard_normal((16, graph.n)).astype(np.float32)
    d0, _, v = josd.make_osd_decoder(graph, np.full(graph.n, 0.02), josd.OSD_0, 0)(
        jnp.asarray(syn), jnp.asarray(llrs)
    )
    x0, _, valid = tosd.make_osd_decoder(
        graph, np.full(graph.n, 0.02), tosd.OSD_0, 0, "cpu"
    )(torch.from_numpy(syn), torch.from_numpy(llrs))
    assert (x0.numpy() == np.asarray(d0)).all()
    assert (valid.numpy() == np.asarray(v)).all()
    assert valid.numpy().all()
