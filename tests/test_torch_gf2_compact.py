"""The plain models of the warp variants of K4' and K2',
``masked_solve_compact_reference`` and ``osd0_compact_reference``, held
against ``masked_solve_reference`` and ``osd0_reference`` and against the JAX
package's ``make_masked_solver`` and ``make_osd0_solver`` (Pallas, interpret
mode), bit for bit.

K4's warp variant eliminates only each lane's own ``count`` columns and the
syndrome, built from ``var_chks``, instead of the whole [H | s]; on the card
it is held against the plain versions (tests/test_torch_kernels.py). Here,
without a card, this is the check that the compaction changes nothing. The
tolerance is exact: x0 and the bad rows are GF(2) results.

Inputs are made with numpy from a seed (BSC syndromes, random LLRs, their
stable orders) on surface d=13 and toric d=20. Counts cover a random count
per lane, 0, 1, the edges of one 32-bit row word (31, 32, 33) and of two
(63, 64), every column, LSD's first growth round and the peeling decoder's
forest-solve order.

K2's warp variant keeps the syndrome beside the matrix, walks a lane's
columns 32 at a time, one word a row built from ``var_chks``, replays the
pivots it has recorded on each further word, and starts a lane again at full
width once it has more pivots than the record holds (48 at d=13, 0 to 3 on
the small codes here). Its cases: random orders (lanes above 32 and 64
columns and above 48 pivots), BP-posterior orders (lanes that end early),
one error whose bit is the lane's 41st column (lanes that end in the second
word), zero syndromes, and
uniformly random syndromes, which on the rank-deficient toric code lie
outside the column space (``valid`` false, the lane runs to full rank); on
hamming(3), surface d=3, 5, 13 and toric d=6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldpc_tpu.ops.gf2_pallas import make_masked_solver, make_osd0_solver
from ldpc_tpu.ops.pcm import compile_pcm as jax_compile_pcm
from ldpc_tpu_torch.codes import hamming_code, surface_code, toric_code
from ldpc_tpu_torch.ops import bp_cuda, gf2, gf2_cuda, uf
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, channel_llr
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch

torch.set_num_threads(1)

LANES = 24
P = 0.03


@pytest.fixture(scope="module")
def codes():
    out = {}
    for name, hx in (("surface13", surface_code(13).hx), ("toric20", toric_code(20).hx)):
        graph = compile_pcm(hx)
        rng = np.random.default_rng(13)
        errors = (rng.random((LANES, graph.n)) < P).astype(np.uint8)
        syn = (errors @ graph.dense.T % 2).astype(np.uint8)
        syn[1] = 0  # a zero-syndrome lane
        llr = rng.normal(3.0, 2.0, (LANES, graph.n)).astype(np.float32)
        out[name] = (
            graph,
            graph_to_torch(graph, "cpu"),
            make_masked_solver(jax_compile_pcm(hx), interpret=True),
            torch.from_numpy(syn),
            torch.from_numpy(llr),
        )
    return out


def _case(graph, tg, syn, llr, kind):
    """``(order, count)`` of one count case."""
    B, n = llr.shape
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32)
    if kind == "random":
        count = np.random.default_rng(5).integers(0, n + 1, B)
    elif kind == "n":
        count = np.full(B, n)
    elif kind == "growth_round":
        # LSD's first growth round: every cluster empty, then one grow_round
        empty = torch.zeros(B, dtype=torch.int32)
        _, bad = gf2_cuda.masked_solve_reference(tg, syn, order, empty)
        in_bit, _ = uf.grow_round(tg, torch.zeros((B, n), dtype=torch.bool), bad,
                                  uf.llr_rank(llr), 1)
        return uf.cluster_columns(in_bit, llr)
    elif kind == "forest_order":
        # make_peel_decoder's final solve: grown clusters, interior columns
        # ascending, then boundary columns ascending
        in_bit, _, _ = uf.grow_until_valid(tg, syn, llr, 0)
        interior = tg.var_mask[:, 1]
        col_key = (torch.arange(n) + torch.where(interior, 0, n)).float()
        return uf.cluster_columns(in_bit, col_key.expand_as(llr))
    else:
        count = np.full(B, kind)
    return order, torch.from_numpy(count.astype(np.int32))


@pytest.mark.parametrize(
    "kind", ["random", 0, 1, 31, 32, 33, 63, 64, "n", "growth_round", "forest_order"]
)
@pytest.mark.parametrize("name", ["surface13", "toric20"])
def test_compact_model_matches_full_elimination_and_jax(codes, name, kind):
    graph, tg, jax_solver, syn, llr = codes[name]
    order, count = _case(graph, tg, syn, llr, kind)
    x_c, bad_c = gf2_cuda.masked_solve_compact_reference(tg, syn, order, count)
    x_r, bad_r = gf2_cuda.masked_solve_reference(tg, syn, order, count)
    x_j, bad_j = jax_solver(
        jnp.asarray(syn.numpy()), jnp.asarray(order.numpy()), jnp.asarray(count.numpy())
    )
    assert x_c.dtype == torch.uint8 and bad_c.dtype == torch.bool
    assert x_c.shape == (LANES, graph.n) and bad_c.shape == (LANES, graph.m)
    assert torch.equal(x_c, x_r) and torch.equal(bad_c, bad_r)
    assert (x_c.numpy() == np.asarray(x_j)).all()
    assert (bad_c.numpy() == np.asarray(bad_j)).all()
    assert not bool(x_c[1].any() or bad_c[1].any())  # the zero syndrome
    if kind == 0:
        assert torch.equal(bad_c, syn.bool())
    if kind in ("n", "forest_order"):
        # every cluster's (or the whole) system is solved
        solved = ~bad_c.any(dim=1)
        x = x_c.numpy().astype(np.int64)
        assert ((x @ graph.dense.T % 2 == syn.numpy())[solved.numpy()]).all()
        if kind == "forest_order":
            assert bool(solved.all())


OSD0_CODES = {
    "hamming3": lambda: hamming_code(3),
    "surface3": lambda: surface_code(3).hx,
    "surface5": lambda: surface_code(5).hx,
    "surface13": lambda: surface_code(13).hx,
    "toric6": lambda: toric_code(6).hx,
}


@pytest.fixture(scope="module")
def osd0_codes():
    out = {}
    for name, make in OSD0_CODES.items():
        hx = make()
        graph = compile_pcm(hx)
        out[name] = (
            graph,
            graph_to_torch(graph, "cpu"),
            make_osd0_solver(jax_compile_pcm(hx), interpret=True),
            gf2.batched_rank(graph.dense),
        )
    return out


def _osd0_case(graph, tg, kind):
    """``(syndromes (LANES, m) uint8, llr (LANES, n) float32)`` of one case;
    each lane's order is the stable argsort of its LLRs."""
    rng = np.random.default_rng(29)
    errors = (rng.random((LANES, graph.n)) < 0.08).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    llr = rng.normal(3.0, 2.0, (LANES, graph.n)).astype(np.float32)
    if kind == "zero":
        syn[:] = 0
    elif kind == "outside":
        syn = rng.integers(0, 2, (LANES, graph.m)).astype(np.uint8)
    elif kind == "second_word":
        # one error a lane, its bit at place 40 of the lane's order (or last)
        place = min(40, graph.n - 1)
        for b in range(LANES):
            e = int(rng.integers(graph.n))
            others = rng.permutation(np.delete(np.arange(graph.n), e))
            lane_order = np.concatenate([others[:place], [e], others[place:]])
            llr[b, lane_order] = np.arange(graph.n, dtype=np.float32)
            syn[b] = graph.dense[:, e]
    elif kind == "bp_order":
        llr0 = torch.from_numpy(channel_llr(np.full(graph.n, 0.08)))
        res = bp_cuda.bp_parallel_reference(
            tg, torch.from_numpy(syn), llr0, MINIMUM_SUM, 5, 0.625)
        llr = res.llr_posterior.numpy()
    return torch.from_numpy(syn), torch.from_numpy(llr)


@pytest.mark.parametrize(
    "kind", ["random_order", "bp_order", "second_word", "zero", "outside"])
@pytest.mark.parametrize("name", list(OSD0_CODES))
def test_osd0_compact_model_matches_plain_version_and_jax(osd0_codes, name, kind):
    graph, tg, jax_solver, rank = osd0_codes[name]
    syn, llr = _osd0_case(graph, tg, kind)
    order = torch.argsort(llr, dim=1, stable=True).to(torch.int32)
    x_c, v_c = gf2_cuda.osd0_compact_reference(tg, syn, order, rank)
    x_r, v_r = gf2_cuda.osd0_reference(tg, syn, order, rank)
    x_j, v_j = jax_solver(jnp.asarray(syn.numpy()), jnp.asarray(llr.numpy()))
    assert x_c.dtype == torch.uint8 and v_c.dtype == torch.bool
    assert x_c.shape == (LANES, graph.n) and v_c.shape == (LANES,)
    assert torch.equal(x_c, x_r) and torch.equal(v_c, v_r)
    assert (x_c.numpy() == np.asarray(x_j)).all()
    assert (v_c.numpy() == np.asarray(v_j)).all()
    valid = v_c.numpy()
    x = x_c.numpy().astype(np.int64)
    assert ((x @ graph.dense.T % 2 == syn.numpy())[valid]).all()
    all_cols = torch.full((LANES,), graph.n)
    walked = gf2_cuda.columns_walked(tg, syn, order, all_cols, rank, True)
    pivots = gf2_cuda.pivots_taken(tg, syn, order, all_cols, rank, True)
    if kind == "zero":
        assert not bool(x_c.any()) and valid.all() and int(walked.max()) == 0
    if name == "toric6" and kind == "outside":
        # a lane outside the column space never takes the fast exit: full rank
        assert not valid.all() and bool((pivots[~v_c] == rank).all())
        assert bool((walked[~v_c] > 32).all())
    elif name != "toric6":
        assert valid.all()  # these codes' checks are independent
    if name == "surface13" and kind == "random_order":
        # lanes on their third word, and lanes that start again at full width
        assert int((walked > 64).sum()) and int((pivots > 48).sum())
    if name == "surface13" and kind == "second_word":
        # lanes that end in the second word, after the replay
        assert int(((walked > 32) & (walked <= 64) & (pivots <= 48)).sum())
    if name == "surface13" and kind == "bp_order":
        assert int((walked <= 32).sum())  # lanes that end in the first word
