"""The plain model of K4's warp variant, ``masked_solve_compact_reference``,
held against ``masked_solve_reference`` and against the JAX package's
``make_masked_solver`` (Pallas, interpret mode), bit for bit.

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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldpc_tpu.ops.gf2_pallas import make_masked_solver
from ldpc_tpu.ops.pcm import compile_pcm as jax_compile_pcm
from ldpc_tpu_torch.codes import surface_code, toric_code
from ldpc_tpu_torch.ops import gf2_cuda, uf
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
