"""The CUDA kernels K1' (csrc/bp_parallel.cu, float32 and its float64
single-scan instance), K2'-K5' (csrc/gf2_elim.cu, each in its warp, block
and device variants, forced by the wrappers' ``variant`` keyword), the
flip sweep (csrc/flip.cu), the fold engines K6'-K8' (csrc/bp_fold.cu,
csrc/bp_exact.cu, each with its lane state in shared or device memory,
forced by ``state``) and MBP over GF(4), K9' (csrc/mbp.cu),
held against their plain PyTorch versions on the card.

Marked ``cuda``: every test skips without a CUDA device. This file imports
no jax, so on a machine without it run it without the repository's
conftest (which configures jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import bivariate_bicycle_code, surface_code, toric_code
import ldpc_tpu_torch
from ldpc_tpu_torch.ops import bp_cuda, bp_fold, flip, gf2, gf2_cuda, mbp, mbp_cuda
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, PRODUCT_SUM, channel_llr, serial_order_table
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch

pytestmark = pytest.mark.cuda

LANES = 8192
P = 0.01


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def codes(dev):
    out = {}
    for name, code in (("surface13", surface_code(13)), ("toric20", toric_code(20))):
        graph = compile_pcm(code.hx)
        rng = np.random.default_rng(7)
        errors = (rng.random((LANES, graph.n)) < P).astype(np.uint8)
        syn = (errors @ graph.dense.T % 2).astype(np.uint8)
        out[name] = (
            graph,
            graph_to_torch(graph, dev),
            torch.from_numpy(syn).to(dev),
            torch.from_numpy(channel_llr(np.full(graph.n, P))).to(dev),
        )
    return out


def _assert_k1_equal(ker, ref, method):
    """Min-sum: bit-exact (same operations in the same order, no FMA
    contraction). Product-sum: posteriors within rtol 1e-4 (tanh/log of
    the CUDA math library on both sides; a cumulative product may round
    differently)."""
    assert torch.equal(ker.converged, ref.converged)
    assert torch.equal(ker.iterations, ref.iterations)
    if method == MINIMUM_SUM:
        assert torch.equal(ker.decoding, ref.decoding)
        assert torch.equal(ker.llr_posterior, ref.llr_posterior)
    else:
        torch.testing.assert_close(
            ker.llr_posterior, ref.llr_posterior, rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize(
    "method,alpha", [(MINIMUM_SUM, 0.625), (MINIMUM_SUM, 0.0), (PRODUCT_SUM, 1.0)]
)
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k1_matches_plain_version(codes, name, method, alpha, state):
    """Both places a lane's state can live, each against the plain version;
    the bare ``bp_parallel`` takes the variant its footprint chooses."""
    _, tg, syn, llr0 = codes[name]
    before = bp_cuda.LAUNCHES
    if state == bp_cuda.state_variant(tg.m, tg.n, tg.dc):
        ker = bp_cuda.bp_parallel(tg, syn, llr0, method, 30, alpha)
    else:
        ker = bp_cuda.bp_parallel_cuda(tg, syn, llr0, method, 30, alpha, state=state)
    assert bp_cuda.LAUNCHES == before + 1
    ref = bp_cuda.bp_parallel_reference(tg, syn, llr0, method, 30, alpha)
    torch.cuda.synchronize()
    _assert_k1_equal(ker, ref, method)
    assert ker.decoding.is_contiguous() and ker.llr_posterior.is_contiguous()


@pytest.mark.parametrize("max_iter", [0, 1, 6, 30])
@pytest.mark.parametrize("lanes", [1, 31, 33, 1001])
def test_k1_short_runs_and_odd_batches(codes, lanes, max_iter):
    """Odd batches leave a block part empty and its lanes stop at different
    iterations; max_iter 0 returns llr0, zeros, not converged, 0 iterations."""
    _, tg, syn, llr0 = codes["surface13"]
    s = syn[:lanes].contiguous()
    for state in ("shared", "device"):
        ker = bp_cuda.bp_parallel_cuda(tg, s, llr0, MINIMUM_SUM, max_iter, 0.625, state=state)
        ref = bp_cuda.bp_parallel_reference(tg, s, llr0, MINIMUM_SUM, max_iter, 0.625)
        for a, b in zip(ker, ref):
            assert torch.equal(a, b)
    if max_iter == 0:
        assert torch.equal(ker.llr_posterior, llr0.expand(lanes, -1))
        assert not bool(ker.decoding.any() or ker.converged.any() or ker.iterations.any())


@pytest.mark.parametrize("distance", [24, 31])
def test_k1_large_codes(dev, distance):
    """Toric d=24 keeps its state in shared memory above 48 KB a block (the
    opt-in); d=31 is above the per-lane budget and takes the device-memory
    variant by itself. Both bit-identical to the plain version."""
    graph = compile_pcm(toric_code(distance, compute_logicals=False).hx)
    tg = graph_to_torch(graph, dev)
    rng = np.random.default_rng(distance)
    errors = (rng.random((300, graph.n)) < 0.03).astype(np.uint8)
    syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, 0.03))).to(dev)
    state = bp_cuda.state_variant(graph.m, graph.n, graph.dc)
    assert state == ("shared" if distance == 24 else "device")
    before = dict(bp_cuda.STATE_LAUNCHES)
    ker = bp_cuda.bp_parallel(tg, syn, llr0, MINIMUM_SUM, 30, 0.625)
    assert bp_cuda.STATE_LAUNCHES[state] == before[state] + 1
    ref = bp_cuda.bp_parallel_reference(tg, syn, llr0, MINIMUM_SUM, 30, 0.625)
    torch.cuda.synchronize()
    _assert_k1_equal(ker, ref, MINIMUM_SUM)
    assert ker.iterations.unique().numel() > 1  # lanes stop apart


# K2'-K5' variants, each forced
ELIM_VARIANTS = ["warp", "block", "device"]


def _k2(tg, syn, order, rank, variant):
    """One K2' call in a forced variant (None: the bare ``osd0``, which takes
    the default), held against the plain version and the compact model; the
    variant's counter moves (more than once only where the device variant
    runs the batch in chunks)."""
    counted = variant or gf2_cuda.elim_variant("osd0", tg.m, tg.n)
    before = dict(gf2_cuda.VARIANT_LAUNCHES["osd0"])
    total = gf2_cuda.LAUNCHES
    if variant is None:
        x_k, v_k = gf2_cuda.osd0(tg, syn, order, rank)
    else:
        x_k, v_k = gf2_cuda.osd0_cuda(tg, syn, order, rank, variant=variant)
    after = gf2_cuda.VARIANT_LAUNCHES["osd0"]
    moved = after[counted] - before[counted]
    assert moved == 1 or (counted == "device" and moved > 1)
    assert gf2_cuda.LAUNCHES == total + moved
    x_r, v_r = gf2_cuda.osd0_reference(tg, syn, order, rank)
    torch.cuda.synchronize()
    assert x_k.dtype == x_r.dtype and v_k.dtype == v_r.dtype
    assert torch.equal(x_k, x_r) and torch.equal(v_k, v_r)
    x_c, v_c = gf2_cuda.osd0_compact_reference(tg, syn, order, rank)
    assert torch.equal(x_c, x_r) and torch.equal(v_c, v_r)
    return x_k, v_k


@pytest.mark.parametrize("variant", [None, *ELIM_VARIANTS])
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k2_matches_plain_version(codes, name, variant):
    """Bit-identical x0 and validity in every variant; x0 solves H x = s on
    valid lanes. On these BP-posterior orders a lane walks few columns,
    a rare one into its second word."""
    graph, tg, syn, llr0 = codes[name]
    llr = bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 30, 0.625).llr_posterior
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()
    rank = gf2.batched_rank(graph.dense)
    x_k, v_k = _k2(tg, syn, order, rank, variant)
    x, s, v = x_k.cpu().numpy(), syn.cpu().numpy(), v_k.cpu().numpy()
    assert v.all()
    assert ((x @ graph.dense.T) % 2 == s).all()


@pytest.mark.parametrize("variant", ELIM_VARIANTS)
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k2_invalid_lanes_match_plain_version(codes, name, variant):
    """Random syndromes of a rank-deficient H include ones outside its
    image: those lanes run to full rank and are invalid. With random orders
    most lanes take more pivots than the warp variant's record holds (48 at
    d=13, 327 at toric d=20), so it starts them again at full width."""
    graph, tg, syn, _ = codes[name]
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.integers(0, 2, (512, graph.m)).astype(np.uint8)).to(syn.device)
    order = torch.from_numpy(
        np.argsort(rng.random((512, graph.n)), axis=1).astype(np.int32)
    ).to(syn.device)
    rank = gf2.batched_rank(graph.dense)
    all_cols = torch.full((512,), graph.n, device=syn.device)
    walked = gf2_cuda.columns_walked(tg, s, order, all_cols, rank, True)
    pivots = gf2_cuda.pivots_taken(tg, s, order, all_cols, rank, True)
    assert int((walked > 64).sum()) > 256
    assert int((pivots > (48 if name == "surface13" else 327)).sum()) > 256
    _, v_k = _k2(tg, s, order, rank, variant)
    if name == "toric20":
        assert not bool(v_k.all())
        assert bool((pivots[~v_k] == rank).all())  # an invalid lane reached full rank
    else:
        assert bool(v_k.all())  # the surface code's checks are independent


@pytest.mark.parametrize("variant", ELIM_VARIANTS)
@pytest.mark.parametrize("lanes", [1, 31, 33, 1001])
def test_k2_odd_batches_mixed_lanes_and_zero_syndromes(codes, lanes, variant):
    """Odd batches leave a block of 4 lanes part empty. Interleaved in one
    launch: lanes that end early (BP-posterior orders), lanes that walk
    several words and may start again at full width (random orders), zero
    syndromes, and lanes that end in their second word, after the replay of
    their recorded pivots (one error, its bit the lane's 41st column)."""
    graph, tg, syn, order = _orders(codes, "surface13", lanes)
    n = graph.n
    rng = np.random.default_rng(lanes)
    order_np, syn_np = order.cpu().numpy().copy(), syn.cpu().numpy().copy()
    kind = np.arange(lanes) % 4
    for b in np.flatnonzero(kind == 1):
        order_np[b] = rng.permutation(n)
    syn_np[kind == 2] = 0
    for b in np.flatnonzero(kind == 3):
        e = int(rng.integers(n))
        others = rng.permutation(np.delete(np.arange(n), e))
        order_np[b] = np.concatenate([others[:40], [e], others[40:]])
        syn_np[b] = graph.dense[:, e]
    order = torch.from_numpy(order_np).to(syn.device)
    s = torch.from_numpy(syn_np).to(syn.device)
    rank = gf2.batched_rank(graph.dense)
    x_k, v_k = _k2(tg, s, order, rank, variant)
    assert bool(v_k.all()) and not bool(x_k.cpu()[kind == 2].any())
    assert ((x_k.cpu().numpy() @ graph.dense.T) % 2 == syn_np).all()
    if lanes > 1:
        all_cols = torch.full((lanes,), n, device=syn.device)
        walked = gf2_cuda.columns_walked(tg, s, order, all_cols, rank, True).cpu().numpy()
        assert walked[kind == 1].max() > 64 and walked[kind == 2].max() == 0
        assert 0 < walked[kind == 0].max() <= 64
        assert ((walked[kind == 3] > 32) & (walked[kind == 3] <= 64)).any()


def _orders(codes, name, lanes=None):
    """Each lane's columns least-reliable-first, from 30 iterations of K1'."""
    graph, tg, syn, llr0 = codes[name]
    if lanes is not None:
        syn = syn[:lanes].contiguous()
    llr = bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 30, 0.625).llr_posterior
    return graph, tg, syn, torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()


# counts at the edges of K4's one-word (register) rows, and 2 words
COUNT_EDGES = [0, 1, 31, 32, 33, 63, 64]


def _counts(graph, syn, kind, seed=5):
    """Per-lane column counts: random 0..n, all 0, all n, one edge of
    COUNT_EDGES for every lane, or every edge and n in turn ("edges")."""
    B = syn.shape[0]
    if kind == "random":
        c = np.random.default_rng(seed).integers(0, graph.n + 1, B)
    elif kind == "edges":
        c = np.resize(np.array(COUNT_EDGES + [graph.n]), B)
    elif isinstance(kind, int):
        c = np.full(B, kind)
    else:
        c = np.full(B, 0 if kind == "zero" else graph.n)
    return torch.from_numpy(c.astype(np.int32)).to(syn.device)


def _assert_exports_equal(ker, ref):
    for a, b in zip(ker, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _elim(kname, variant, *args):
    """One K3'-K5' launch in a forced variant; its variant's counter moves
    (K4' more than once only where the device variant runs the batch in
    chunks)."""
    before = dict(gf2_cuda.VARIANT_LAUNCHES[kname])
    out = getattr(gf2_cuda, f"{kname}_cuda")(*args, variant=variant)
    after = gf2_cuda.VARIANT_LAUNCHES[kname]
    moved = after[variant] - before[variant]
    assert moved == 1 or (moved > 1 and (kname, variant) == ("masked_solve", "device"))
    assert sum(after.values()) == sum(before.values()) + moved
    return out


def _assert_k4_k5(tg, syn, order, cnt, variants=ELIM_VARIANTS):
    """K4' and K5' in each variant against their plain versions; K4's warp
    variant also against its compact model."""
    x_r, bad_r = gf2_cuda.masked_solve_reference(tg, syn, order, cnt)
    ref = gf2_cuda.masked_export_reference(tg, syn, order, cnt)
    compact = gf2_cuda.masked_solve_compact_reference(tg, syn, order, cnt)
    assert torch.equal(compact[0], x_r) and torch.equal(compact[1], bad_r)
    for variant in variants:
        x_k, bad_k = _elim("masked_solve", variant, tg, syn, order, cnt)
        ker = _elim("masked_export", variant, tg, syn, order, cnt)
        torch.cuda.synchronize()
        assert torch.equal(x_k, x_r) and torch.equal(bad_k, bad_r), variant
        _assert_exports_equal(ker, ref)
    return x_r, bad_r


@pytest.mark.parametrize("variant", ELIM_VARIANTS)
@pytest.mark.parametrize("lanes", [None, 1001, 33, 31, 1])
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k3_matches_plain_version(codes, name, lanes, variant):
    """Bit-identical words, pivot columns and used rows in each variant;
    every lane ends with rank pivots; odd batch sizes leave a block part
    empty."""
    graph, tg, syn, order = _orders(codes, name, lanes)
    rank = gf2.batched_rank(graph.dense)
    ker = _elim("rref_export", variant, tg, syn, order, rank)
    ref = gf2_cuda.rref_export_reference(tg, syn, order, rank)
    torch.cuda.synchronize()
    _assert_exports_equal(ker, ref)
    assert bool((ker[2].sum(dim=1) == rank).all())


def test_k3_k4_k5_default_variants(codes):
    """The bare wrappers take the variant elim_variant names, and count it:
    K3' and K4' take the warp variant up to toric d=20 (46.5 KB a lane),
    K5' only while four lanes share a block (surface d=13, not toric
    d=20)."""
    graph20 = codes["toric20"][0]
    for kname, variant in (("osd0", "warp"), ("rref_export", "warp"),
                           ("masked_solve", "warp"), ("masked_export", "block")):
        assert gf2_cuda.elim_variant(kname, graph20.m, graph20.n) == variant
    graph, tg, syn, order = _orders(codes, "surface13", 257)
    for kname in gf2_cuda.VARIANT_LAUNCHES:
        assert gf2_cuda.elim_variant(kname, graph.m, graph.n) == "warp"
    rank = gf2.batched_rank(graph.dense)
    cnt = _counts(graph, syn, "random")
    before = {k: dict(v) for k, v in gf2_cuda.VARIANT_LAUNCHES.items()}
    _assert_exports_equal(gf2_cuda.rref_export(tg, syn, order, rank),
                          gf2_cuda.rref_export_reference(tg, syn, order, rank))
    for a, b in zip(gf2_cuda.masked_solve(tg, syn, order, cnt),
                    gf2_cuda.masked_solve_reference(tg, syn, order, cnt)):
        assert torch.equal(a, b)
    _assert_exports_equal(gf2_cuda.masked_export(tg, syn, order, cnt),
                          gf2_cuda.masked_export_reference(tg, syn, order, cnt))
    x0, valid = gf2_cuda.osd0(tg, syn, order, rank)
    x0_r, valid_r = gf2_cuda.osd0_reference(tg, syn, order, rank)
    assert torch.equal(x0, x0_r) and torch.equal(valid, valid_r)
    for kname, by_variant in gf2_cuda.VARIANT_LAUNCHES.items():
        assert by_variant["warp"] == before[kname]["warp"] + 1
        assert by_variant["block"] == before[kname]["block"]
        assert by_variant["device"] == before[kname]["device"]


@pytest.mark.parametrize("variant", ELIM_VARIANTS)
@pytest.mark.parametrize("count", ["random", "zero", "full", "edges", *COUNT_EDGES])
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k4_k5_match_plain_versions(codes, name, count, variant):
    """Every count at the edges of K4's register rows (one word holds 31
    columns and the syndrome), in each variant."""
    graph, tg, syn, order = _orders(codes, name, 1001)
    cnt = _counts(graph, syn, count)
    x_k, bad_k = _assert_k4_k5(tg, syn, order, cnt, [variant])
    if count == "zero":
        assert not bool(x_k.any()) and torch.equal(bad_k, syn.bool())


@pytest.mark.parametrize("lanes", [1, 31, 33])
def test_k4_k5_odd_batches(codes, lanes):
    """Batches that leave a block of 4 lanes part empty, every variant (the
    device variant's blocks are lanes, and its scratch is the batch's)."""
    graph, tg, syn, order = _orders(codes, "surface13", lanes)
    _assert_k4_k5(tg, syn, order, _counts(graph, syn, "edges"))


@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_elim_zero_syndromes(codes, name):
    """Zero syndromes: every variant equals the plain versions, K4' returns
    zeros and no bad row."""
    graph, tg, syn, order = _orders(codes, name, 65)
    zero = torch.zeros_like(syn)
    rank = gf2.batched_rank(graph.dense)
    ref = gf2_cuda.rref_export_reference(tg, zero, order, rank)
    for variant in ELIM_VARIANTS:
        _assert_exports_equal(_elim("rref_export", variant, tg, zero, order, rank), ref)
    x, bad = _assert_k4_k5(tg, zero, order, _counts(graph, zero, "edges"))
    assert not bool(x.any() or bad.any())


def test_elim_toric30(dev):
    """Toric d=30 (m = 900, 215 KB a lane in the warp variant): the block
    variant by default, the warp and device variants when forced, all
    bit-identical."""
    graph = compile_pcm(toric_code(30, compute_logicals=False).hx)
    tg = graph_to_torch(graph, dev)
    for kname in gf2_cuda.VARIANT_LAUNCHES:
        assert gf2_cuda.elim_variant(kname, graph.m, graph.n) == "block"
    rng = np.random.default_rng(30)
    errors = (rng.random((48, graph.n)) < 0.03).astype(np.uint8)
    syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
    order = torch.from_numpy(np.argsort(rng.random((48, graph.n)), axis=1).astype(np.int32))
    order = order.to(dev)
    rank = gf2.batched_rank(graph.dense)
    ref = gf2_cuda.rref_export_reference(tg, syn, order, rank)
    for variant in ELIM_VARIANTS:
        _assert_exports_equal(_elim("rref_export", variant, tg, syn, order, rank), ref)
    _assert_k4_k5(tg, syn, order, _counts(graph, syn, "edges"))
    before = gf2_cuda.VARIANT_LAUNCHES["rref_export"]["block"]
    _assert_exports_equal(gf2_cuda.rref_export(tg, syn, order, rank), ref)
    assert gf2_cuda.VARIANT_LAUNCHES["rref_export"]["block"] == before + 1


def test_k4_first_growth_round_matches_plain_version(codes):
    """The shapes of LSD's first growth rounds: K4' on real cluster masks,
    every variant."""
    from ldpc_tpu_torch.ops import uf

    graph, tg, syn, llr0 = codes["surface13"]
    res = bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 30, 0.625)
    failed = torch.nonzero(~res.converged).squeeze(1)
    s, llr = syn[failed].contiguous(), res.llr_posterior[failed]
    in_bit = torch.zeros_like(llr, dtype=torch.bool)
    for _ in range(3):
        order, cnt = uf.cluster_columns(in_bit, llr)
        _, bad = _assert_k4_k5(tg, s, order, cnt)
        in_bit, _ = uf.grow_round(tg, in_bit, bad, uf.llr_rank(llr), 1)


def test_wrappers_validate_inputs(codes):
    graph, tg, syn, llr0 = codes["surface13"]
    with pytest.raises(ValueError, match="uint8"):
        bp_cuda.bp_parallel_cuda(tg, syn.int(), llr0, MINIMUM_SUM, 5, 0.625)
    with pytest.raises(ValueError, match="float32 or float64"):
        bp_cuda.bp_parallel_cuda(tg, syn, llr0.half(), MINIMUM_SUM, 5, 0.625)
    with pytest.raises(ValueError, match="min-sum"):  # float64 is single-scan's instance
        bp_cuda.bp_parallel_cuda(tg, syn, llr0.double(), PRODUCT_SUM, 5, 0.625)
    order = torch.zeros((syn.shape[0], graph.n), dtype=torch.int64, device=syn.device)
    with pytest.raises(ValueError, match="int32"):
        gf2_cuda.osd0_cuda(tg, syn, order, 1)
    o32 = order.to(torch.int32)
    cnt = torch.zeros(syn.shape[0], dtype=torch.int32, device=syn.device)
    with pytest.raises(ValueError, match="rref_export_cuda: order must be int32"):
        gf2_cuda.rref_export_cuda(tg, syn, order, 1)
    with pytest.raises(ValueError, match="masked_solve_cuda: count must be int32"):
        gf2_cuda.masked_solve_cuda(tg, syn, o32, cnt.long())
    with pytest.raises(ValueError, match="masked_export_cuda: count must have shape"):
        gf2_cuda.masked_export_cuda(tg, syn, o32, cnt[:-1])
    with pytest.raises(ValueError, match="masked_solve_cuda: syndromes must be uint8"):
        gf2_cuda.masked_solve_cuda(tg, syn.int(), o32, cnt)
    with pytest.raises(ValueError, match="masked_export_cuda: count is on cpu"):
        gf2_cuda.masked_export_cuda(tg, syn, o32, cnt.cpu())
    with pytest.raises(ValueError, match="variant must be"):
        gf2_cuda.masked_solve_cuda(tg, syn, o32, cnt, variant="lane")
    with pytest.raises(ValueError, match="flip_cuda: syndromes must be uint8"):
        flip.flip_cuda(tg, syn.int(), 5, 0, 1)
    # more rows than a variant's threads can own are refused: the launcher
    # refuses the warp variant above 1,024, the wrapper a block above 32,768
    big = compile_pcm(toric_code(60, compute_logicals=False).hx)  # m = 3600, n = 7200
    tg_big = graph_to_torch(big, syn.device)
    s = torch.zeros((1, big.m), dtype=torch.uint8, device=syn.device)
    o = torch.zeros((1, big.n), dtype=torch.int32, device=syn.device)
    c = torch.zeros(1, dtype=torch.int32, device=syn.device)
    with pytest.raises(RuntimeError, match="launch failed"):
        gf2_cuda.masked_solve_cuda(tg_big, s, o, c, variant="warp")
    # the block variant forced on a lane above a block's shared memory
    with pytest.raises(RuntimeError, match="launch failed"):
        gf2_cuda.rref_export_cuda(tg_big, s, o, 1, variant="block")
    # a refused launch leaves no error behind for the next one to report
    bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 1, 0.625)
    torch.cuda.synchronize()


def _large_code(dev, distance, lanes, p=0.03):
    """A toric code whose lane does not fit a block's shared memory, with
    syndromes of random errors and BP-posterior orders."""
    graph = compile_pcm(toric_code(distance, compute_logicals=False).hx)
    tg = graph_to_torch(graph, dev)
    rng = np.random.default_rng(distance)
    errors = (rng.random((lanes, graph.n)) < p).astype(np.uint8)
    syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, p))).to(dev)
    llr = bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 30, 0.625).llr_posterior
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32).contiguous()
    return graph, tg, syn, order


@pytest.mark.parametrize("distance,lanes", [(31, 300), (60, 6)])
def test_large_codes_take_the_device_variant(dev, distance, lanes):
    """Toric d=31 (238,328 bytes a lane, just above a block's 232,448) and
    d=60 (3.25 MB a lane): K2'-K5' take the device variant by themselves and
    equal their plain versions bit for bit."""
    graph, tg, syn, order = _large_code(dev, distance, lanes)
    for kname in gf2_cuda.VARIANT_LAUNCHES:
        assert gf2_cuda.elim_variant(kname, graph.m, graph.n) == "device"
    rank = gf2.batched_rank(graph.dense)
    before = {k: dict(v) for k, v in gf2_cuda.VARIANT_LAUNCHES.items()}
    x0, valid = _k2(tg, syn, order, rank, None)
    assert bool(valid.all())
    assert ((x0.cpu().numpy() @ graph.dense.T) % 2 == syn.cpu().numpy()).all()
    ker = gf2_cuda.rref_export(tg, syn, order, rank)
    _assert_exports_equal(ker, gf2_cuda.rref_export_reference(tg, syn, order, rank))
    assert bool((ker[2].sum(dim=1) == rank).all())
    for kind in ("edges", "random"):
        cnt = _counts(graph, syn, kind)
        for a, b in zip(gf2_cuda.masked_solve(tg, syn, order, cnt),
                        gf2_cuda.masked_solve_reference(tg, syn, order, cnt)):
            assert torch.equal(a, b)
        _assert_exports_equal(gf2_cuda.masked_export(tg, syn, order, cnt),
                              gf2_cuda.masked_export_reference(tg, syn, order, cnt))
    for kname, by_variant in gf2_cuda.VARIANT_LAUNCHES.items():
        assert by_variant["device"] > before[kname]["device"]
        assert by_variant["warp"] == before[kname]["warp"]
        assert by_variant["block"] == before[kname]["block"]


def test_device_variant_runs_a_large_batch_in_chunks(codes, monkeypatch):
    """A batch whose scratch would pass SCRATCH_BYTES runs in chunks of
    lanes, one counted launch each, the last one part full."""
    graph, tg, syn, order = _orders(codes, "surface13", 1001)
    lane_bytes = 4 * (graph.m * tg.packed.shape[1] + graph.m)
    monkeypatch.setattr(gf2_cuda, "SCRATCH_BYTES", 300 * lane_bytes)
    rank = gf2.batched_rank(graph.dense)
    cnt = _counts(graph, syn, "random")
    before = {k: v["device"] for k, v in gf2_cuda.VARIANT_LAUNCHES.items()}
    x0, valid = gf2_cuda.osd0_cuda(tg, syn, order, rank, variant="device")
    x4, bad = gf2_cuda.masked_solve_cuda(tg, syn, order, cnt, variant="device")
    torch.cuda.synchronize()
    for kname in ("osd0", "masked_solve"):
        assert gf2_cuda.VARIANT_LAUNCHES[kname]["device"] == before[kname] + 4
    x0_r, valid_r = gf2_cuda.osd0_reference(tg, syn, order, rank)
    x4_r, bad_r = gf2_cuda.masked_solve_reference(tg, syn, order, cnt)
    assert torch.equal(x0, x0_r) and torch.equal(valid, valid_r)
    assert torch.equal(x4, x4_r) and torch.equal(bad, bad_r)


def test_k4_forest_solve_order_matches_plain_version(codes):
    """K4' in the peeling decoder's final solve: each lane's grown cluster,
    interior columns ascending, then boundary columns ascending; every
    variant (counts reach well past one word)."""
    from ldpc_tpu_torch.ops import uf

    graph, tg, syn, _ = codes["surface13"]
    s = syn[:2001].contiguous()
    llr = torch.zeros((s.shape[0], graph.n), dtype=torch.float32, device=s.device)
    in_bit, _, _ = uf.grow_until_valid(tg, s, llr, 0)
    interior = tg.var_mask[:, 1]
    col_key = torch.arange(graph.n, device=s.device) + torch.where(interior, 0, graph.n)
    order, cnt = uf.cluster_columns(in_bit, col_key.float().expand_as(llr))
    x, bad = _assert_k4_k5(tg, s, order, cnt)
    assert not bool(bad.any())
    assert ((x.cpu().numpy() @ graph.dense.T) % 2 == s.cpu().numpy()).all()


def _assert_flip_equal(tg, syn, max_iter, pfreq, seed=7):
    before = flip.FLIP_LAUNCHES
    ker = flip.flip(tg, syn, max_iter, pfreq, seed)
    assert flip.FLIP_LAUNCHES == before + 1
    ref = flip.flip_reference(tg, syn, max_iter, pfreq, seed)
    torch.cuda.synchronize()
    for a, b in zip(ker, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    return ker


@pytest.mark.parametrize("pfreq,max_iter", [(0, "n"), (3, 12), (1, 5)])
@pytest.mark.parametrize("lanes", [1001, 65, 1])
def test_flip_matches_plain_version(codes, lanes, pfreq, max_iter):
    """Bit-identical decodings, convergence flags and iterations, with and
    without p-flip (both sides draw the same hashed coins); odd batches
    that leave a block part empty."""
    graph, tg, syn, _ = codes["surface13"]
    iters = graph.n if max_iter == "n" else max_iter
    dec, conv, _ = _assert_flip_equal(tg, syn[:lanes].contiguous(), iters, pfreq)
    c = conv.cpu().numpy()
    x = dec.cpu().numpy()
    assert ((x @ graph.dense.T % 2)[c] == syn[:lanes].cpu().numpy()[c]).all()


def test_flip_zero_syndromes_and_toric20(codes):
    """Zero syndromes converge at sweep 0 with a zero decoding; toric d=20
    (n=800, 13 syndrome words per lane) matches with and without p-flip."""
    graph, tg, syn, _ = codes["surface13"]
    zero = torch.zeros((129, graph.m), dtype=torch.uint8, device=syn.device)
    dec, conv, iters = _assert_flip_equal(tg, zero, graph.n, 2)
    assert not bool(dec.any()) and bool(conv.all()) and not bool(iters.any())
    graph20, tg20, syn20, _ = codes["toric20"]
    _assert_flip_equal(tg20, syn20, graph20.n, 0)
    _assert_flip_equal(tg20, syn20[:2048].contiguous(), 10, 3, seed=0xFFFFFFFF)


def test_flip_converges_in_the_middle_of_a_scan(codes):
    """One error a lane, at every bit in turn: the lane's flip lands at
    every place of a 32-bit scan, and where it empties the syndrome the lane
    stops there, mid-scan and mid-sweep, with that sweep reported."""
    graph, tg, syn, _ = codes["surface13"]
    errors = np.eye(graph.n, dtype=np.uint8)
    s = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(syn.device)
    dec, conv, iters = _assert_flip_equal(tg, s, graph.n, 0)
    hit = conv.cpu().numpy() & (dec.cpu().numpy() == errors).all(axis=1)
    assert bool((iters[conv] == 1).all())
    assert len({int(j) % 32 for j in np.flatnonzero(hit)}) == 32  # every place of a scan


# ---- K6'-K8', the fold engines (csrc/bp_fold.cu) ------------------------------

FOLD_LANES = 1024
FIX, TAB, REL = bp_fold.ORDER_FIXED, bp_fold.ORDER_TABLE, bp_fold.ORDER_RELATIVE


def _order(mode, n, max_iter, dev):
    if mode == FIX:
        return torch.arange(n, dtype=torch.int32, device=dev)
    if mode == TAB:
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        return serial_order_table(n, max_iter, gen, dev)
    return None


def _assert_fold_equal(ker, ref, method):
    """Min-sum: every output bit-identical (same operations in the same
    order, no FMA contraction). Product-sum: decisions, flags and
    iterations identical, posteriors within rtol 1e-4 (float32) or 1e-9
    (float64): tanh and log of the CUDA math library on both sides."""
    (kr, ks), (rr, rs) = [(x, None) if isinstance(x, bp_fold.BpResult) else x for x in (ker, ref)]
    assert torch.equal(kr.converged, rr.converged)
    assert torch.equal(kr.iterations, rr.iterations)
    assert torch.equal(kr.decoding, rr.decoding)
    if method == MINIMUM_SUM:
        assert torch.equal(kr.llr_posterior, rr.llr_posterior)
        if ks is not None:
            assert torch.equal(ks, rs)
    else:
        rtol = 1e-4 if kr.llr_posterior.dtype == torch.float32 else 1e-9
        torch.testing.assert_close(kr.llr_posterior, rr.llr_posterior, rtol=rtol, atol=1e-5,
                                   equal_nan=True)


def _fold_call(kernel, args, state):
    """The kernel in ``state`` (None: the footprint's choice, through the
    dispatcher) against its plain version; the state's counter moves by
    one."""
    tg, llr0 = args[0], args[2]
    relative = kernel == "bp_serial" and args[-1] == REL
    counted = state or bp_fold.state_variant(kernel, tg.m, tg.n, tg.dc, tg.dv, llr0.dtype,
                                             relative)
    before, launches = bp_fold.STATE_LAUNCHES[kernel][counted], bp_fold.LAUNCHES[kernel]
    if state is None:
        ker = getattr(bp_fold, kernel)(*args)
    else:
        ker = getattr(bp_fold, f"{kernel}_cuda")(*args, state=state)
    torch.cuda.synchronize()
    assert bp_fold.STATE_LAUNCHES[kernel][counted] == before + 1
    assert bp_fold.LAUNCHES[kernel] == launches + 1
    ref = getattr(bp_fold, f"{kernel}_reference")(*args)
    return ker, ref


def _llr0(graph, dev, dtype, p=P):
    return torch.from_numpy(channel_llr(np.full(graph.n, p), np.float64)).to(dev, dtype)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("mode,method,alpha,dtype", [
    (FIX, MINIMUM_SUM, 0.625, torch.float32), (FIX, PRODUCT_SUM, 1.0, torch.float64),
    (TAB, MINIMUM_SUM, 0.0, torch.float32), (REL, MINIMUM_SUM, 0.625, torch.float64),
    (REL, PRODUCT_SUM, 1.0, torch.float32),
])
def test_k6_matches_plain_version(codes, mode, method, alpha, dtype, state):
    graph, tg, syn, _ = codes["surface13"]
    s = syn[:FOLD_LANES].contiguous()
    args = (tg, s, _llr0(graph, s.device, dtype), method, 30, alpha,
            _order(mode, graph.n, 30, s.device), mode)
    ker, ref = _fold_call("bp_serial", args, state)
    _assert_fold_equal(ker, ref, method)
    assert ker.llr_posterior.dtype == dtype


@pytest.mark.parametrize("lanes", [1, 33])
def test_fold_engines_odd_batches_and_lanes_apart(codes, lanes):
    """Odd batches, a lane that converges in iteration 1 (a zero syndrome)
    beside one that runs to max_iter (an odd-weight syndrome, which no
    toric-code error makes: every bit lies in two checks), in every engine
    and both states; max_iter 0 returns llr0 and zeros."""
    graph, tg, syn, _ = codes["toric20"]
    dev = syn.device
    s = syn[:lanes].clone()
    s[0] = 0
    if lanes > 1:
        odd = np.random.default_rng(3).integers(0, 2, graph.m).astype(np.uint8)
        odd[0] ^= 1 - odd.sum() % 2
        s[1] = torch.from_numpy(odd)
    for max_iter in (0, 30):
        for state in ("shared", "device"):
            for dtype in (torch.float32, torch.float64):
                l0 = _llr0(graph, dev, dtype)
                soft = ((1 - 2 * s.to(dtype)) * 5).contiguous()
                calls = [("bp_serial", (tg, s, l0, MINIMUM_SUM, max_iter, 0.625, None, REL)),
                         ("bp_soft_info", (tg, soft, l0, max_iter, 0.625, 3.0))]
                if dtype == torch.float64:
                    calls.append(("bp_parallel_exact", (tg, s, l0, MINIMUM_SUM, max_iter, 0.625)))
                for kernel, args in calls:
                    ker, ref = _fold_call(kernel, args, state)
                    _assert_fold_equal(ker, ref, MINIMUM_SUM)
                    res = ker if isinstance(ker, bp_fold.BpResult) else ker[0]
                    if max_iter == 0:
                        assert torch.equal(res.llr_posterior, l0.expand(lanes, -1))
                        assert not bool(res.decoding.any() or res.converged.any())
                    else:
                        assert bool(res.converged[0]) and int(res.iterations[0]) == 1
                        if lanes > 1:
                            assert not bool(res.converged[1]) and int(res.iterations[1]) == 30


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_matches_plain_version(codes, dtype, state):
    """Soft syndromes (1 - 2 s) + 0.3 N(0, 1) scaled by 2/0.3^2, cutoff 10:
    the virtual-update rules fire, and the final soft syndrome is held too."""
    graph, tg, syn, _ = codes["surface13"]
    s = syn[:FOLD_LANES]
    noise = np.random.default_rng(7).standard_normal(tuple(s.shape))
    soft = ((1 - 2 * s.double().cpu()) + 0.3 * torch.from_numpy(noise)).to(s.device)
    soft = (soft.to(dtype) * torch.tensor(2 / 0.09, dtype=dtype, device=s.device)).contiguous()
    args = (tg, soft, _llr0(graph, s.device, dtype), 30, 0.625, 10.0)
    ker, ref = _fold_call("bp_soft_info", args, state)
    _assert_fold_equal(ker, ref, MINIMUM_SUM)
    assert not torch.equal(ker[1], soft)  # the rules changed some check


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("method,alpha", [(MINIMUM_SUM, 0.625), (MINIMUM_SUM, 0.0),
                                          (PRODUCT_SUM, 1.0)])
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k8_matches_plain_version(codes, name, method, alpha, state):
    graph, tg, syn, _ = codes[name]
    s = syn[:FOLD_LANES].contiguous()
    args = (tg, s, _llr0(graph, s.device, torch.float64), method, 30, alpha)
    ker, ref = _fold_call("bp_parallel_exact", args, state)
    _assert_fold_equal(ker, ref, method)


def test_fold_engines_toric20_serial(codes):
    """Toric d=20 (n=800) in its default state: serial-relative float64
    (device state: with its sort, level and bucket arrays a lane takes
    about 40 KB) and serial float32 in a given order."""
    graph, tg, syn, _ = codes["toric20"]
    s = syn[:256].contiguous()
    order = torch.from_numpy(np.random.default_rng(2).permutation(graph.n).astype(np.int32))
    for args in ((tg, s, _llr0(graph, s.device, torch.float64), MINIMUM_SUM, 30, 0.625, None, REL),
                 (tg, s, _llr0(graph, s.device, torch.float32), MINIMUM_SUM, 30, 0.0,
                  order.to(s.device), FIX)):
        ker, ref = _fold_call("bp_serial", args, None)
        _assert_fold_equal(ker, ref, MINIMUM_SUM)


def test_fold_engines_toric60_take_device_state(dev):
    """Toric d=60 in float64 (m=3600, n=7200: a lane's state is 180 KB) is
    above the shared budget: each engine takes its device state by itself
    and equals its plain version; no code is refused for its size."""
    graph = compile_pcm(toric_code(60, compute_logicals=False).hx)
    tg = graph_to_torch(graph, dev)
    rng = np.random.default_rng(60)
    errors = (rng.random((6, graph.n)) < 0.01).astype(np.uint8)
    s = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
    l0 = _llr0(graph, dev, torch.float64)
    soft = ((1 - 2 * s.double()) * 8).contiguous()
    for kernel, args in (("bp_serial", (tg, s, l0, MINIMUM_SUM, 2, 0.625,
                                        _order(FIX, graph.n, 2, dev), FIX)),
                         ("bp_soft_info", (tg, soft, l0, 2, 0.625, 5.0)),
                         ("bp_parallel_exact", (tg, s, l0, MINIMUM_SUM, 30, 0.625))):
        assert bp_fold.state_variant(kernel, graph.m, graph.n, graph.dc, graph.dv,
                                     torch.float64) == "device"
        ker, ref = _fold_call(kernel, args, None)
        _assert_fold_equal(ker, ref, MINIMUM_SUM)


@pytest.mark.parametrize("state", ["shared", "device"])
def test_k6_random_levels_wider_than_a_chunk(codes, state):
    """A random serial table on toric d=20 (drawn with numpy): every row
    has a level of more than 64 bits, i.e. above 128 (bit, slot) pairs, so
    a step takes the level in several chunks of several rounds of the
    warp; bit for bit."""
    graph, tg, syn, llr0 = codes["toric20"]
    rng = np.random.default_rng(20)
    table = np.stack([rng.permutation(graph.n) for _ in range(12)]).astype(np.int32)
    table = torch.from_numpy(table).to(syn.device)
    levels = bp_fold.level_schedule(tg, table)
    widths = levels.ptr[:, 1:].long() - levels.ptr[:, :-1].long()
    assert bool((widths.max(dim=1).values * graph.dv > 128).all())
    args = (tg, syn[:512].contiguous(), llr0, MINIMUM_SUM, 12, 0.625, table, TAB)
    ker, ref = _fold_call("bp_serial", args, state)
    _assert_fold_equal(ker, ref, MINIMUM_SUM)
    again = bp_fold.bp_serial_cuda(*args, state=state, levels=levels)
    _assert_fold_equal(again, ref, MINIMUM_SUM)


@pytest.fixture(scope="module")
def gross(dev):
    """The gross [[144,12,12]] code's hx (m=72, n=144, dc=6, dv=3), 512
    syndromes at p=0.03."""
    code = bivariate_bicycle_code(12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])
    graph = compile_pcm(code.hx)
    rng = np.random.default_rng(144)
    errors = (rng.random((512, graph.n)) < 0.03).astype(np.uint8)
    syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
    return graph, graph_to_torch(graph, dev), syn


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("mode,method,alpha,dtype", [
    (FIX, MINIMUM_SUM, 0.625, torch.float32), (TAB, MINIMUM_SUM, 0.0, torch.float64),
    (REL, MINIMUM_SUM, 0.625, torch.float32), (REL, PRODUCT_SUM, 1.0, torch.float64),
])
def test_k6_gross_code(gross, mode, method, alpha, dtype, state):
    """Three checks a bit (dv=3): a level's pairs do not fall on whole
    warps, and the levels pass keeps three checks a position."""
    graph, tg, syn = gross
    args = (tg, syn, _llr0(graph, syn.device, dtype, 0.03), method, 30, alpha,
            _order(mode, graph.n, 30, syn.device), mode)
    ker, ref = _fold_call("bp_serial", args, state)
    _assert_fold_equal(ker, ref, method)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_gross_code(gross, dtype, state):
    graph, tg, syn = gross
    noise = np.random.default_rng(9).standard_normal(tuple(syn.shape))
    soft = ((1 - 2 * syn.double().cpu()) + 0.3 * torch.from_numpy(noise)).to(syn.device)
    soft = (soft.to(dtype) * torch.tensor(2 / 0.09, dtype=dtype, device=syn.device)).contiguous()
    args = (tg, soft, _llr0(graph, syn.device, dtype, 0.03), 30, 0.625, 10.0)
    ker, ref = _fold_call("bp_soft_info", args, state)
    _assert_fold_equal(ker, ref, MINIMUM_SUM)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("mode", [FIX, REL])
def test_k6_six_checks_a_bit(dev, mode, state):
    """A random code with six checks a bit (m=48, n=96): a chunk of a level
    is 21 bits, a thread's pairs step across bits, and serial-relative's
    levels pass takes its path for columns above four checks."""
    rng = np.random.default_rng(6)
    H = np.zeros((48, 96), dtype=np.uint8)
    for j in range(96):
        H[rng.choice(48, 6, replace=False), j] = 1
    graph = compile_pcm(H)
    assert graph.dv == 6
    errors = (rng.random((512, graph.n)) < 0.02).astype(np.uint8)
    syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)
    args = (graph_to_torch(graph, dev), syn, _llr0(graph, dev, torch.float32, 0.02),
            MINIMUM_SUM, 30, 0.625, _order(mode, graph.n, 30, dev), mode)
    ker, ref = _fold_call("bp_serial", args, state)
    _assert_fold_equal(ker, ref, MINIMUM_SUM)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_relative_equal_and_nan_posteriors(dev, dtype, state):
    """Serial-relative with equal and NaN posteriors in one lane: surface
    d=5 with five columns in no check, whose channel LLRs (NaN, -NaN, +0,
    -0 and the code's own) stay their posteriors; every lane starts on
    equal posteriors. Held bit for bit (NaN equal to NaN) against the plain
    version on the CPU, where torch.argsort sorts NaN last."""
    H = surface_code(5).hx.toarray()
    H = np.hstack([H, np.zeros((H.shape[0], 5), dtype=H.dtype)])
    graph = compile_pcm(H)
    rng = np.random.default_rng(5)
    errors = (rng.random((256, graph.n)) < 0.05).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llr = channel_llr(np.full(graph.n, 0.05), np.float64)
    llr[-5:] = [np.nan, -np.nan, 0.0, -0.0, llr[0]]
    l0 = torch.from_numpy(llr).to(dtype)
    args = (MINIMUM_SUM, 20, 0.625, None, REL)
    ker = bp_fold.bp_serial_cuda(graph_to_torch(graph, dev), torch.from_numpy(syn).to(dev),
                                 l0.to(dev), *args, state=state)
    ref = bp_fold.bp_serial_reference(graph_to_torch(graph, "cpu"), torch.from_numpy(syn), l0,
                                      *args)
    torch.cuda.synchronize()
    for got, want in zip(ker, ref):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, equal_nan=True)
    assert bool(ker.llr_posterior[:, -5:-3].isnan().all())


def _random_code(m, n, weights, seed):
    """An (m, n) code whose row i has ``weights[i]`` ones at random."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), dtype=np.uint8)
    for i, w in enumerate(weights):
        H[i, rng.choice(n, w, replace=False)] = 1
    return compile_pcm(H)


def _k8_call(graph, dev, syn, method, alpha, state, p, max_iter=30):
    args = (graph_to_torch(graph, dev), syn, _llr0(graph, dev, torch.float64, p), method, max_iter,
            alpha)
    before = bp_fold.STATE_LAUNCHES["bp_parallel_exact"][state]
    ker = bp_fold.bp_parallel_exact_cuda(*args, state=state)
    torch.cuda.synchronize()
    assert bp_fold.STATE_LAUNCHES["bp_parallel_exact"][state] == before + 1
    return ker, bp_fold.bp_parallel_exact_reference(*args)


def _syndromes(graph, dev, lanes, p, seed):
    rng = np.random.default_rng(seed)
    errors = (rng.random((lanes, graph.n)) < p).astype(np.uint8)
    return torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8)).to(dev)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("method,alpha", [(MINIMUM_SUM, 0.625), (PRODUCT_SUM, 1.0)])
def test_k8_gross_code(gross, method, alpha, state):
    """K8' on three checks a bit (dv=3, rows of 6): a bit's three c2v
    values in registers, rows in the 8-slot instance."""
    graph, _, syn = gross
    ker, ref = _k8_call(graph, syn.device, syn, method, alpha, state, 0.03)
    _assert_fold_equal(ker, ref, method)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("method,alpha", [(MINIMUM_SUM, 0.625), (PRODUCT_SUM, 1.0)])
def test_k8_six_checks_a_bit(dev, method, alpha, state):
    """K8' on the random code of six checks a bit (m=48, n=96) of
    test_k6_six_checks_a_bit: columns wider than the register path take
    the loop that folds from the messages in place; rows of up to 20
    slots take the 32-slot instance."""
    rng = np.random.default_rng(6)
    H = np.zeros((48, 96), dtype=np.uint8)
    for j in range(96):
        H[rng.choice(48, 6, replace=False), j] = 1
    graph = compile_pcm(H)
    assert graph.dv == 6
    syn = _syndromes(graph, dev, 512, 0.02, 6)
    ker, ref = _k8_call(graph, dev, syn, method, alpha, state, 0.02)
    _assert_fold_equal(ker, ref, method)


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("dc,method,alpha", [
    (4, PRODUCT_SUM, 1.0), (5, PRODUCT_SUM, 1.0), (12, PRODUCT_SUM, 1.0), (32, PRODUCT_SUM, 1.0),
    (5, MINIMUM_SUM, 0.625), (12, MINIMUM_SUM, 0.0), (32, MINIMUM_SUM, 0.625),
    (40, MINIMUM_SUM, 0.625),
])
def test_k8_wide_rows(dev, dc, method, alpha, state):
    """Rows of up to ``dc`` slots (the widest exactly dc, the others from
    dc/2 up, some bits in no check): each product-sum instance (4, 8, 16
    and 32 slots) and the min-sum register path, and a min-sum row above
    32 slots, which takes the loop that reads a row twice."""
    m, n = 12, 96
    weights = [dc] + list(np.random.default_rng(dc).integers(max(2, dc // 2), dc + 1, m - 1))
    graph = _random_code(m, n, weights, dc)
    assert graph.dc == dc
    syn = _syndromes(graph, dev, 512, 0.02, dc)
    ker, ref = _k8_call(graph, dev, syn, method, alpha, state, 0.02)
    _assert_fold_equal(ker, ref, method)


@pytest.mark.parametrize("state", ["shared", "device"])
def test_k8_lanes_per_block_tails(codes, state):
    """Batches of 1, 2, 3 and 5 lanes and of 8*1000 + 1 (the kernel's
    eight lanes a block, a part-filled last block; enough lanes that each
    warp claims several): a lane that converges in iteration 1 (a zero
    syndrome), one that never does (an odd-weight toric syndrome) and the
    rest at their own iterations, in one block. The profile receives each
    lane's cycles: every lane spends some in its prologue, check passes and
    bit passes, and only the lane that runs to max_iter in a syndrome test
    of its own (the others' ride on their check passes)."""
    graph, tg, syn, _ = codes["toric20"]
    dev = syn.device
    sizes = (1, 2, 3, 5, 8 * 1000 + 1)
    base = syn[:max(sizes)].clone()
    assert base.shape[0] == max(sizes)
    base[0] = 0
    odd = np.random.default_rng(3).integers(0, 2, graph.m).astype(np.uint8)
    odd[0] ^= 1 - odd.sum() % 2
    base[1] = torch.from_numpy(odd)
    for B in sizes:
        s = base[:B].contiguous()
        assert s.shape[0] == B
        ker, ref = _k8_call(graph, dev, s, MINIMUM_SUM, 0.625, state, P)
        _assert_fold_equal(ker, ref, MINIMUM_SUM)
        assert bool(ker.converged[0]) and int(ker.iterations[0]) == 1
        if B > 1:
            assert not bool(ker.converged[1]) and int(ker.iterations[1]) == 30
        if B > 2:
            assert len(set(ker.iterations.tolist())) >= (2 if B < 5 else 3)
    l0 = _llr0(graph, dev, torch.float64)
    prof = torch.zeros((5, 5), dtype=torch.int64, device=dev)
    res = bp_fold.bp_parallel_exact_cuda(tg, base[:5].contiguous(), l0, MINIMUM_SUM, 30, 0.625,
                                         state=state, profile=prof)
    torch.cuda.synchronize()
    assert bool((prof[:, :3] > 0).all()) and bool((prof >= 0).all())
    assert int(res.iterations[1]) == 30 and int(prof[1, 3]) > 0
    assert bool((prof[res.converged, 3] == 0).all())


@pytest.mark.parametrize("alpha", [0.625, 0.0])
def test_k1_fixed_alpha_matches_plain_version(codes, alpha):
    """Single-scan: K1' with its dynamic factor off, both states."""
    _, tg, syn, llr0 = codes["surface13"]
    ref = bp_cuda.bp_parallel_reference(tg, syn, llr0, MINIMUM_SUM, 30, alpha, dynamic_alpha=False)
    for state in ("shared", "device"):
        ker = bp_cuda.bp_parallel_cuda(tg, syn, llr0, MINIMUM_SUM, 30, alpha, state=state,
                                       dynamic_alpha=False)
        torch.cuda.synchronize()
        _assert_k1_equal(ker, ref, MINIMUM_SUM)


def test_fold_wrappers_validate_inputs(codes):
    graph, tg, syn, _ = codes["surface13"]
    l64 = _llr0(graph, syn.device, torch.float64)
    order = torch.arange(graph.n, dtype=torch.int32, device=syn.device)
    with pytest.raises(ValueError, match="bp_serial_cuda: inputs must be on a CUDA device"):
        bp_fold.bp_serial_cuda(graph_to_torch(graph, "cpu"), syn.cpu(), l64.cpu(), MINIMUM_SUM,
                               5, 0.625, order.cpu(), FIX)
    with pytest.raises(ValueError, match="init_llr must be one of"):
        bp_fold.bp_serial_cuda(tg, syn, l64.half(), MINIMUM_SUM, 5, 0.625, order, FIX)
    with pytest.raises(ValueError, match="syndromes must be uint8"):
        bp_fold.bp_serial_cuda(tg, syn.int(), l64, MINIMUM_SUM, 5, 0.625, order, FIX)
    with pytest.raises(ValueError, match="order must be int32"):
        bp_fold.bp_serial_cuda(tg, syn, l64, MINIMUM_SUM, 5, 0.625, order.long(), FIX)
    with pytest.raises(ValueError, match="order must have shape"):
        bp_fold.bp_serial_cuda(tg, syn, l64, MINIMUM_SUM, 5, 0.625, order[None], TAB)
    with pytest.raises(ValueError, match="input must be contiguous"):
        bp_fold.bp_serial_cuda(tg, syn.t().contiguous().t(), l64, MINIMUM_SUM, 5, 0.625, order,
                               FIX)
    with pytest.raises(ValueError, match="bp_parallel_exact_cuda: init_llr must be one of"):
        bp_fold.bp_parallel_exact_cuda(tg, syn, l64.float(), MINIMUM_SUM, 5, 0.625)
    with pytest.raises(ValueError, match="soft must have init_llr's dtype"):
        bp_fold.bp_soft_info_cuda(tg, syn.float(), l64, 5, 0.625, 1.0)
    with pytest.raises(ValueError, match="state must be"):
        bp_fold.bp_parallel_exact_cuda(tg, syn, l64, MINIMUM_SUM, 5, 0.625, state="lane")


@pytest.mark.parametrize("cls,kw,kernel", [
    ("BpOsdDecoder", {"schedule": "serial"}, "bp_serial"),
    ("BpOsdDecoder", {"schedule": "serial_relative"}, "bp_serial"),
    ("BpOsdDecoder", {"schedule": "serial", "random_serial_schedule": True}, "bp_serial"),
    ("BpOsdDecoder", {"dtype": "float64"}, "bp_parallel_exact"),
    ("BpLsdDecoder", {"schedule": "serial"}, "bp_serial"),
    ("BeliefFindDecoder", {"schedule": "serial_relative"}, "bp_serial"),
    ("BpFlipDecoder", {"schedule": "serial"}, "bp_serial"),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()))
def test_fold_launch_counters_move_on_each_path(codes, cls, kw, kernel):
    """Each decoder on the card goes through its fold engine, once a batch
    (only the parallel float32 schedule cascades), and its first rows equal
    the CPU path's (but for the random schedule, whose permutations each
    device's generator draws)."""
    graph, _, syn, _ = codes["surface13"]
    syn_np = syn[:512].cpu().numpy()

    def make(device):
        return getattr(ldpc_tpu_torch, cls)(graph.dense, error_rate=P, max_iter=30,
                                            ms_scaling_factor=0.625, device=device, **kw)

    before = bp_fold.LAUNCHES[kernel]
    out = make("cuda").decode_batch(syn_np)
    assert bp_fold.LAUNCHES[kernel] == before + 1
    if cls != "BpFlipDecoder":  # BpFlip guarantees H x = s on converged rows only
        assert ((out.astype(np.int64) @ graph.dense.T % 2) == syn_np).all()
    if not kw.get("random_serial_schedule"):
        assert (make("cpu").decode_batch(syn_np[:32]) == out[:32]).all()


# ---- K1' in float64: the single-scan instance --------------------------------------


@pytest.mark.parametrize("state", ["shared", "device"])
@pytest.mark.parametrize("alpha", [0.625, 0.0])
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_k1_float64_matches_plain_version(codes, name, alpha, state):
    """K1''s float64 min-sum with its factor fixed (single-scan) against the
    plain version: bit-exact, posteriors in float64."""
    graph, tg, syn, _ = codes[name]
    llr64 = torch.from_numpy(channel_llr(np.full(graph.n, P), np.float64)).to(syn.device)
    ref = bp_cuda.bp_parallel_reference(tg, syn, llr64, MINIMUM_SUM, 30, alpha,
                                        dynamic_alpha=False)
    before = dict(bp_cuda.DTYPE_LAUNCHES)
    ker = bp_cuda.bp_parallel_cuda(tg, syn, llr64, MINIMUM_SUM, 30, alpha, state=state,
                                   dynamic_alpha=False)
    torch.cuda.synchronize()
    assert bp_cuda.DTYPE_LAUNCHES["float64"] == before["float64"] + 1
    assert ker.llr_posterior.dtype == torch.float64
    _assert_k1_equal(ker, ref, MINIMUM_SUM)


def test_k1_float64_refuses_product_sum(codes):
    graph, tg, syn, _ = codes["surface13"]
    llr64 = torch.zeros(graph.n, dtype=torch.float64, device=syn.device)
    with pytest.raises(ValueError, match="min-sum"):
        bp_cuda.bp_parallel_cuda(tg, syn, llr64, PRODUCT_SUM, 5, 1.0)


def test_single_scan_float64_path_launches_k1(codes):
    """``BpDecoder(dtype=float64).decode_single_scan`` on the card runs K1''s
    float64 instance once a syndrome and equals the CPU path."""
    graph, _, syn, _ = codes["surface13"]
    rows = syn[:64].cpu().numpy()
    rows = rows[rows.any(axis=1)]

    def make(device):
        return ldpc_tpu_torch.BpDecoder(graph.dense, error_rate=P, max_iter=30,
                                        ms_scaling_factor=0.625, dtype="float64", device=device)

    card, cpu = make("cuda"), make("cpu")
    before = bp_cuda.DTYPE_LAUNCHES["float64"]
    for s in rows:
        x = card.decode_single_scan(s)
        assert (x == cpu.decode_single_scan(s)).all()
        assert (card.converge, card.iter) == (cpu.converge, cpu.iter)
    assert bp_cuda.DTYPE_LAUNCHES["float64"] == before + len(rows)


# ---- K9': MBP over GF(4) ---------------------------------------------------------------


def _gf4_workload(code, lanes, seed, dev, p=0.01):
    hx, hz = (np.asarray(h.todense(), np.uint8) for h in (code.hx, code.hz))
    H = np.vstack([3 * hz, hx]).astype(np.uint8)
    rng = np.random.default_rng(seed)
    e = rng.choice(4, size=(lanes, H.shape[1]), p=[1 - 3 * p, p, p, p]).astype(np.uint8)
    syn = torch.from_numpy(mbp.pauli_syndrome(H, e).astype(np.uint8)).to(dev)
    return mbp.gf4_to_torch(mbp.compile_gf4(H), dev), syn


@pytest.fixture(scope="module")
def gf4_codes(dev):
    gross = bivariate_bicycle_code(12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])
    return {
        "surface13": _gf4_workload(surface_code(13), 4096, 7, dev),
        "toric20": _gf4_workload(toric_code(20), 1024, 20, dev),
        "gross": _gf4_workload(gross, 512, 144, dev, p=0.02),
    }


def _assert_mbp_equal(ker, ref):
    """Decisions, flags and iteration counts equal; posteriors within rtol
    1e-9 (float64) or 1e-4 (float32), atol 1e-5: both sides call CUDA's exp,
    log and tanh and round every sum in the same order."""
    for k in (0, 2, 3):
        assert torch.equal(ker[k], ref[k])
    rtol = 1e-9 if ker[1].dtype == torch.float64 else 1e-4
    torch.testing.assert_close(ker[1], ref[1], rtol=rtol, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("method,alpha,beta", [(mbp.PRODUCT_SUM, 1.0, 0.0),
                                               (mbp.MINIMUM_SUM, 1.0, 0.0),
                                               (mbp.PRODUCT_SUM, 0.65, 0.5),
                                               (mbp.MINIMUM_SUM, 0.65, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["surface13", "toric20", "gross"])
def test_k9_matches_plain_version(gf4_codes, name, dtype, method, alpha, beta):
    g, syn = gf4_codes[name]
    chan, inv_alpha = mbp.mbp_params(np.full((3, g.n), 0.01), np.full((3, g.n), alpha), dtype,
                                     syn.device)
    ref = mbp.mbp_reference(g, syn, chan, inv_alpha, 30, beta, method, 0.625)
    before = mbp_cuda.DTYPE_LAUNCHES[str(dtype)[6:]]
    ker = mbp_cuda.mbp_cuda(g, syn, chan, inv_alpha, 30, beta, method, 0.625)
    torch.cuda.synchronize()
    assert mbp_cuda.DTYPE_LAUNCHES[str(dtype)[6:]] == before + 1
    _assert_mbp_equal(ker, ref)
    assert ker[2].any() and ker[1].dtype == dtype


@pytest.mark.parametrize("max_iter", [0, 1, 5])
@pytest.mark.parametrize("lanes", [1, 7, 9, 1001])
def test_k9_short_runs_and_odd_batches(gf4_codes, lanes, max_iter):
    """Part-filled blocks of eight lanes, zero syndromes among them, depth 0
    (zero posteriors) and short runs."""
    g, syn = gf4_codes["surface13"]
    syn = syn[:lanes].clone()
    syn[0] = 0
    chan, inv_alpha = mbp.mbp_params(np.full((3, g.n), 0.01), np.ones((3, g.n)), torch.float64,
                                     syn.device)
    ref = mbp.mbp_reference(g, syn, chan, inv_alpha, max_iter, 0.0, mbp.MINIMUM_SUM, 0.625)
    ker = mbp_cuda.mbp_cuda(g, syn, chan, inv_alpha, max_iter, 0.0, mbp.MINIMUM_SUM, 0.625)
    torch.cuda.synchronize()
    _assert_mbp_equal(ker, ref)
    if max_iter == 0:
        assert not ker[1].any() and not ker[2].any()
    else:
        assert ker[2][0] and ker[3][0] == 1


def test_k9_wrapper_validates_inputs(gf4_codes):
    g, syn = gf4_codes["surface13"]
    chan, inv_alpha = mbp.mbp_params(np.full((3, g.n), 0.01), np.ones((3, g.n)), torch.float64,
                                     syn.device)
    with pytest.raises(ValueError, match="CUDA"):
        mbp_cuda.mbp_cuda(g, syn.cpu(), chan, inv_alpha, 5, 0.0, 1, 0.625)
    with pytest.raises(ValueError, match="shape"):
        mbp_cuda.mbp_cuda(g, syn[:, :-1].contiguous(), chan, inv_alpha, 5, 0.0, 1, 0.625)
    with pytest.raises(ValueError, match="dtype"):
        mbp_cuda.mbp_cuda(g, syn, chan, inv_alpha.float(), 5, 0.0, 1, 0.625)
    with pytest.raises(ValueError, match="bp_method"):
        mbp_cuda.mbp_cuda(g, syn, chan, inv_alpha, 5, 0.0, 2, 0.625)


def test_mbp_decoder_on_the_card_matches_cpu(gf4_codes):
    """``MbpDecoder.decode_batch`` on the card launches K9' once and equals
    the CPU path on 256 rows; converged rows reproduce their syndrome."""
    code = surface_code(13)
    hx, hz = (np.asarray(h.todense(), np.uint8) for h in (code.hx, code.hz))
    H = np.vstack([3 * hz, hx]).astype(np.uint8)
    _, syn = gf4_codes["surface13"]
    syn_np = syn[:256].cpu().numpy()

    def make(device):
        return ldpc_tpu_torch.MbpDecoder(Hgf4=H, error_rate=0.03, max_iter=30,
                                         bp_method="min_sum", gamma_parameter=0.625,
                                         device=device)

    card, cpu = make("cuda"), make("cpu")
    before = mbp_cuda.LAUNCHES
    out = card.decode_batch(syn_np)
    assert mbp_cuda.LAUNCHES == before + 1
    assert (out == cpu.decode_batch(syn_np)).all()
    assert (card.converge_batch == cpu.converge_batch).all()
    assert (card.iter_batch == cpu.iter_batch).all()
    conv = card.converge_batch
    assert (mbp.pauli_syndrome(H, out[conv]) == syn_np[conv]).all()


def test_column_order_puts_every_nan_last_on_the_card(dev):
    """torch's CUDA sort puts a NaN whose sign bit is set before -inf;
    ``gf2.column_order`` makes every NaN sort last there too, as on the
    CPU."""
    keys = torch.tensor([[2.0, -float("nan"), -float("inf"), float("nan"), 1.0,
                          float("inf"), -float("nan"), 1.0]] * 3)
    for dt in (torch.float32, torch.float64):
        want = gf2.column_order(keys.to(dt))
        assert torch.equal(gf2.column_order(keys.to(dt).to(dev)).cpu(), want)
        assert want[0].tolist() == [2, 4, 7, 0, 5, 1, 3, 6]
