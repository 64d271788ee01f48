"""The level schedule of K6' and K7' (csrc/bp_fold.cu) on the CPU.

The kernels sweep a serial order level by level: a bit's level is 1 + the
highest level of an earlier bit of the order that shares a check with it,
and the bits of a level update together. This file holds the schedule's
plain model, ``bp_fold.serial_levels``, to its definition (hypothesis over
small random codes and orders; surface d=13, toric d=20 and the gross
[[144,12,12]] code), pins the level counts of index order that the design
rests on (25 at surface d=13, 40 at toric d=20), and shows on the plain
versions that the claim the kernels rest on holds bit for bit: serial BP in
an order equals serial BP in that order re-sorted stably by level (fixed
orders and random-serial tables; min-sum and product-sum; float32 and
float64), and soft-information BP in index order equals it on the code
whose columns are permuted into level order. ``relative_order_reference``,
the plain model of serial-relative's bitonic sort, is held to
``torch.argsort(-post, stable=True)`` with ties, signed zeros, infinities
and NaN.

No tolerance anywhere: every comparison is exact.
"""

import numpy as np
import pytest
import scipy.sparse
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ldpc_tpu_torch.codes import bivariate_bicycle_code, surface_code, toric_code
from ldpc_tpu_torch.ops import bp_fold
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, PRODUCT_SUM, channel_llr
from ldpc_tpu_torch.ops.pcm import compile_pcm, graph_to_torch

torch.set_num_threads(1)

GROSS = (12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])
CODES = {
    "surface13": lambda: surface_code(13).hx,
    "toric20": lambda: toric_code(20).hx,
    "gross": lambda: bivariate_bicycle_code(*GROSS).hx,
}


def _assert_levels_valid(graph, order, bits, ptr):
    """``bits``/``ptr`` (one row) are the levels of ``order``: the bits of
    each level in order position, no two sharing a check, and each
    position's level exactly 1 + the highest level of an earlier bit of
    the order that shares a check with it (1 if none)."""
    n = graph.n
    assert sorted(bits.tolist()) == list(range(n))
    assert ptr[0] == 0 if n else True
    assert np.all(np.diff(np.concatenate([[0], ptr])) >= 0) and ptr[-1] == n
    level_of = np.zeros(n, dtype=np.int64)
    count = int((ptr[:n] < n).sum()) if n else 0
    for lv in range(1, count + 1):
        members = bits[ptr[lv - 1]:ptr[lv]]
        assert len(members), f"level {lv} is empty"
        level_of[members] = lv
        chks = graph.var_chks[members][graph.var_mask[members]]
        assert len(np.unique(chks)) == len(chks), f"level {lv} has two bits in one check"
    pos = np.empty(n, dtype=np.int64)
    pos[np.asarray(order)] = np.arange(n)
    for lv in range(1, count + 1):  # order position inside a level
        assert np.all(np.diff(pos[bits[ptr[lv - 1]:ptr[lv]]]) > 0)
    last = np.zeros(graph.m + 1, dtype=np.int64)
    for j in order:
        chks = graph.var_chks[j][graph.var_mask[j]]
        want = 1 + (last[chks].max() if len(chks) else 0)
        assert level_of[j] == want
        last[chks] = want


@st.composite
def _code_and_order(draw):
    m = draw(st.integers(1, 8))
    n = draw(st.integers(1, 14))
    density = draw(st.sampled_from([0.15, 0.35, 0.6]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    H = (rng.random((m, n)) < density).astype(np.uint8)
    H[rng.integers(m), :] |= H.sum(axis=0) == 0  # most columns in a check
    rows = draw(st.integers(1, 3))
    return H, np.stack([rng.permutation(n) for _ in range(rows)])


@settings(max_examples=80, deadline=None)
@given(_code_and_order())
def test_levels_valid_on_random_codes(case):
    H, orders = case
    graph = compile_pcm(scipy.sparse.csr_matrix(H))
    bits, ptr = bp_fold.serial_levels(graph.var_chks, graph.m, orders)
    assert bits.shape == orders.shape and ptr.shape == (len(orders), graph.n + 1)
    assert bits.dtype == np.int32 and ptr.dtype == np.int32
    for r, order in enumerate(orders):
        _assert_levels_valid(graph, order, bits[r], ptr[r])


@pytest.mark.parametrize("name", list(CODES))
def test_levels_valid_on_codes(name):
    """Index order, three random orders as one table, one row at a time
    and together (the rows do not mix)."""
    graph = compile_pcm(CODES[name]())
    rng = np.random.default_rng(11)
    table = np.stack([np.arange(graph.n)] + [rng.permutation(graph.n) for _ in range(3)])
    bits, ptr = bp_fold.serial_levels(graph.var_chks, graph.m, table)
    for r, order in enumerate(table):
        _assert_levels_valid(graph, order, bits[r], ptr[r])
        one_bits, one_ptr = bp_fold.serial_levels(graph.var_chks, graph.m, order)
        np.testing.assert_array_equal(one_bits[0], bits[r])
        np.testing.assert_array_equal(one_ptr[0], ptr[r])


@pytest.mark.parametrize("name,levels,widest", [("surface13", 25, 24), ("toric20", 40, 38)])
def test_index_order_level_counts(name, levels, widest):
    """The chain of a sweep in index order: 313 steps become 25 levels at
    surface d=13, 800 become 40 at toric d=20."""
    graph = compile_pcm(CODES[name]())
    tg = graph_to_torch(graph, "cpu")
    lv = bp_fold.level_schedule(tg, torch.arange(graph.n, dtype=torch.int32))
    assert lv.bits.dtype == torch.int32 and lv.ptr.dtype == torch.int32
    assert lv.bits.shape == (1, graph.n) and lv.ptr.shape == (1, graph.n + 1)
    assert int(lv.counts()[0]) == levels
    ends = lv.ptr[0, :levels].numpy()
    assert int(np.diff(np.concatenate([[0], ends])).max()) == widest


def _level_sorted(graph, order):
    bits, _ = bp_fold.serial_levels(graph.var_chks, graph.m, order)
    return bits if np.ndim(order) == 2 else bits[0]


def _workload(name, lanes, p, seed=7):
    H = {"surface5": lambda: surface_code(5).hx, "gross": CODES["gross"]}[name]()
    graph = compile_pcm(H)
    rng = np.random.default_rng(seed)
    errors = (rng.random((lanes, graph.n)) < p).astype(np.uint8)
    syn = torch.from_numpy((errors @ graph.dense.T % 2).astype(np.uint8))
    return graph, graph_to_torch(graph, "cpu"), syn, rng


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,alpha", [(MINIMUM_SUM, 0.625), (MINIMUM_SUM, 0.0),
                                          (PRODUCT_SUM, 1.0)])
@pytest.mark.parametrize("mode", [bp_fold.ORDER_FIXED, bp_fold.ORDER_TABLE])
@pytest.mark.parametrize("name", ["surface5", "gross"])
def test_level_sorted_order_is_the_same_serial_sweep(name, mode, method, alpha, dtype):
    """Serial BP's plain version in an order and in that order re-sorted
    stably by level: posteriors, decisions, flags and iterations
    bit-identical."""
    graph, tg, syn, rng = _workload(name, 48, 0.05)
    max_iter = 12
    if mode == bp_fold.ORDER_FIXED:
        order = rng.permutation(graph.n)
    else:
        order = np.stack([rng.permutation(graph.n) for _ in range(max_iter)])
    resorted = _level_sorted(graph, order)
    assert not np.array_equal(resorted, order)
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, 0.05), np.float64)).to(dtype)
    runs = [bp_fold.bp_serial_reference(tg, syn, llr0, method, max_iter, alpha,
                                        torch.from_numpy(np.asarray(o, np.int32)), mode)
            for o in (order, resorted)]
    _assert_same(*runs)
    assert 0 < int(runs[0].converged.sum()) < len(syn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["surface5", "gross"])
def test_soft_info_in_level_order_is_the_same_sweep(name, dtype):
    """K7''s plain version sweeps index order; on the code with its columns
    permuted into level order it sweeps the levels, and its outputs,
    permuted back, are bit-identical (the final soft syndrome too).
    Min-sum's row minimum and sign parity do not depend on the slot order,
    and a bit's slots keep their check order."""
    graph, tg, syn, rng = _workload(name, 48, 0.05)
    perm = _level_sorted(graph, np.arange(graph.n)).astype(np.int64)
    assert not np.array_equal(perm, np.arange(graph.n))
    tg_perm = graph_to_torch(compile_pcm(scipy.sparse.csr_matrix(graph.dense[:, perm])), "cpu")
    llr0 = torch.from_numpy(channel_llr(np.full(graph.n, 0.05), np.float64)).to(dtype)
    soft = (1 - 2 * syn.double()) + 0.3 * torch.from_numpy(rng.standard_normal(syn.shape))
    soft = (soft.to(dtype) * torch.tensor(2 / 0.09, dtype=dtype)).contiguous()
    res, soft_out = bp_fold.bp_soft_info_reference(tg, soft, llr0, 12, 0.625, 10.0)
    res_p, soft_p = bp_fold.bp_soft_info_reference(tg_perm, soft, llr0[perm], 12, 0.625, 10.0)
    inv = torch.from_numpy(np.argsort(perm))
    assert torch.equal(res.decoding, res_p.decoding[:, inv])
    assert torch.equal(res.llr_posterior, res_p.llr_posterior[:, inv])
    assert torch.equal(res.converged, res_p.converged)
    assert torch.equal(res.iterations, res_p.iterations)
    assert torch.equal(soft_out, soft_p)
    assert not torch.equal(soft_out, soft)  # the virtual-update rules fired


SPECIAL = [0.0, -0.0, 1.0, -1.0, 2.5, -2.5, float("inf"), float("-inf"), float("nan"),
           -float("nan"), 1e-40, -1e-40, 3e38, -3e38]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 7, 32, 33, 313])
def test_relative_sort_model_equals_stable_argsort(n, dtype):
    """Ties, signed zeros, subnormals, infinities and NaN of either sign,
    at lengths below, at and above powers of two."""
    rng = np.random.default_rng(n)
    post = torch.from_numpy(rng.choice(SPECIAL, size=(24, n))).to(dtype)
    post[:4] = torch.from_numpy(rng.integers(-2, 3, size=(4, n)).astype(np.float64)).to(dtype)
    want = torch.argsort(-post, dim=1, stable=True)
    assert torch.equal(bp_fold.relative_order_reference(post), want)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.sampled_from(SPECIAL), st.floats(width=32)), min_size=1,
                max_size=70))
def test_relative_sort_model_hypothesis(values):
    post = torch.tensor([values], dtype=torch.float32)
    want = torch.argsort(-post, dim=1, stable=True)
    assert torch.equal(bp_fold.relative_order_reference(post), want)
    assert torch.equal(bp_fold.relative_order_reference(post.double()),
                       torch.argsort(-post.double(), dim=1, stable=True))
