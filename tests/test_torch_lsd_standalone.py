"""The standalone LsdDecoder and the LSD statistics of the port
(ldpc_tpu_torch.decoders.lsd_decoder, decoders.lsd_stats, and
BpLsdDecoder.set_do_stats) held against the JAX package, and ports of the
JAX package's LSD decoder tests (tests/test_lsd_decoder.py) for them.

Inputs are made with numpy from a seed and fed to both sides; the JAX side
runs on the CPU. On CPU tensors the port runs each kernel's plain PyTorch
version. LSD's keys are integers and the statistics are counts, bit lists
and cluster ids, so every comparison is exact; only ``elapsed_time`` (a
wall-clock reading) is left out.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, rep_code, surface_code
from ldpc_tpu.decoders import lsd_stats as jstats
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops.pcm import compile_pcm
from ldpc_tpu_torch.decoders import lsd_stats as tstats
from ldpc_tpu_torch.ops.pcm import graph_to_torch

torch.set_num_threads(1)


def _all_syndromes(m):
    return ((np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)


def _stats_dict(stats):
    d = dataclasses.asdict(stats)
    d.pop("elapsed_time")
    return d


CONFIGS = [dict(), dict(lsd_method="lsd_cs", lsd_order=3), dict(lsd_method="lsd_e", lsd_order=3)]
IDS = ["lsd0", "lsd_cs3", "lsd_e3"]


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_lsd_decoder_hamming_exhaustive_matches_jax(kw):
    """Every syndrome of the [7,4] Hamming code, weights 0.3 + 0.1 j."""
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    syn = _all_syndromes(3)
    weights = 0.3 + 0.1 * np.arange(Hd.shape[1])
    jd = ldpc_tpu.LsdDecoder(H, bits_per_step=1, **kw)
    td = ldpc_tpu_torch.LsdDecoder(H, bits_per_step=1, **kw, device="cpu")
    want = jd.decode_batch(syn, weights)
    got = td.decode_batch(syn, weights)
    assert got.dtype == np.uint8 and (got == want).all()
    assert (td.valid_batch == jd.valid_batch).all() and td.valid_batch.all()
    assert np.array_equal((got @ Hd.T) % 2, syn)
    assert (td.decoding == jd.decoding).all()


@pytest.mark.parametrize("shared", [True, False], ids=["shared_weights", "row_weights"])
@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_lsd_decoder_surface5_matches_jax(kw, shared):
    """Surface d=5: one weight vector shared by every row (broadcast on the
    device), and one weight vector per row."""
    code = surface_code(5)
    Hd = np.asarray(code.hx.todense(), np.uint8)
    rng = np.random.default_rng(3)
    errors = (rng.random((64, Hd.shape[1])) < 0.08).astype(np.uint8)
    syn = (errors @ Hd.T % 2).astype(np.uint8)
    syn[2] = 0
    w = rng.random(Hd.shape[1]) + 0.5
    weights = w if shared else rng.random((64, Hd.shape[1])) + 0.5
    jd = ldpc_tpu.LsdDecoder(code.hx, bits_per_step=1, **kw)
    td = ldpc_tpu_torch.LsdDecoder(code.hx, bits_per_step=1, **kw, device="cpu")
    want = jd.decode_batch(syn, weights)
    got = td.decode_batch(syn, weights)
    assert (got == want).all()
    assert (td.valid_batch == jd.valid_batch).all() and td.valid_batch.all()
    assert np.array_equal((got @ Hd.T) % 2, syn) and not got[2].any()


def test_lsd0_hamming_exhaustive():
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.LsdDecoder(H, bits_per_step=1, device="cpu")
    syn = _all_syndromes(3)
    out = dec.decode_batch(syn, np.ones(Hd.shape[1]))
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, syn)


def test_lsdw_not_heavier_than_lsd0():
    """Higher-order candidates may only lower the solution weight."""
    code = surface_code(5)
    Hd = np.asarray(code.hx.todense(), np.uint8)
    rng = np.random.default_rng(3)
    errors = (rng.random((64, Hd.shape[1])) < 0.08).astype(np.uint8)
    syn = (errors @ Hd.T % 2).astype(np.uint8)
    w = rng.random(Hd.shape[1]) + 0.5
    out0 = ldpc_tpu_torch.LsdDecoder(code.hx, bits_per_step=1, device="cpu").decode_batch(syn, w)
    out5 = ldpc_tpu_torch.LsdDecoder(
        code.hx, bits_per_step=1, lsd_method="lsd_cs", lsd_order=5, device="cpu"
    ).decode_batch(syn, w)
    assert np.array_equal((out0 @ Hd.T) % 2, syn)
    assert np.array_equal((out5 @ Hd.T) % 2, syn)
    assert (out5.sum(axis=1) <= out0.sum(axis=1)).all()
    assert (out5.sum(axis=1) < out0.sum(axis=1)).any()


def test_lsd_decoder_validation_and_single_decode():
    D = functools.partial(ldpc_tpu_torch.LsdDecoder, device="cpu")
    with pytest.raises(TypeError):
        D([[1, 1, 0], [0, 1, 1]])
    dec = D(rep_code(10))
    assert (dec.lsd_method, dec.lsd_order, dec.bits_per_step) == ("LSD_0", 0, 1)
    assert D(rep_code(10), bits_per_step=0).bits_per_step == 10
    with pytest.raises(ValueError):
        dec.lsd_order = 2  # method is LSD_0
    with pytest.raises(ValueError):
        D(rep_code(10), lsd_method="bogus")
    with pytest.raises(ValueError):
        D(rep_code(10), lsd_method="lsd_cs", lsd_order=-1)
    with pytest.warns(UserWarning):
        D(rep_code(10), lsd_method="lsd_e", lsd_order=16)
    with pytest.raises(ValueError, match="syndrome must have length 9"):
        dec.decode(np.zeros(5, np.uint8), np.ones(10))
    with pytest.raises(ValueError, match="bit weights must have length 10"):
        dec.decode(np.zeros(9, np.uint8), np.ones(3))
    Hd = np.asarray(rep_code(10).todense(), np.uint8)
    e = np.zeros(10, np.uint8)
    e[6] = 1
    s = Hd @ e % 2
    x = dec.decode(s, np.full(10, 2.0))
    assert np.array_equal(Hd @ x % 2, s) and x.sum() == 1
    assert not dec.decode(np.zeros(9, np.uint8), np.ones(10)).any()
    assert dec.valid_batch.all()


# ----------------------------------------------------------------------
# statistics
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def surface5_rows():
    """Surface d=5 syndromes and BP posteriors (2 iterations, so LSD has
    work), as BpLsdDecoder hands them to LSD."""
    code = surface_code(5)
    graph = compile_pcm(code.hx)
    rng = np.random.default_rng(149)
    errors = (rng.random((16, graph.n)) < 0.08).astype(np.uint8)
    syn = (errors @ graph.dense.T % 2).astype(np.uint8)
    bp = jbp.make_parallel_decoder(graph, jbp.MINIMUM_SUM, 2, 0.625)
    llrs = np.array(bp(jnp.asarray(syn), jnp.asarray(jbp.channel_llr(np.full(graph.n, 0.08)))).llr_posterior)
    return code, graph, syn, llrs


@pytest.mark.parametrize("bits_per_step", [1, 2])
def test_compute_lsd_statistics_matches_jax(surface5_rows, bits_per_step):
    """The replay of one row's growth, row by row: equal per-cluster
    records (ids, merges, size history, final bits, solution, sparsity)
    and equal timestep history."""
    code, graph, syn, llrs = surface5_rows
    tg = graph_to_torch(graph, "cpu")
    rows = [r for r in range(len(syn)) if syn[r].any()][:4]
    merged = 0
    for r in rows:
        dec = (np.random.default_rng(r).random(graph.n) < 0.3).astype(np.uint8)
        want = jstats.compute_lsd_statistics(
            graph, scipy.sparse.csc_matrix(code.hx), syn[r], llrs[r], bits_per_step, dec
        )
        got = tstats.compute_lsd_statistics(tg, graph.dense, syn[r], llrs[r], bits_per_step, dec)
        assert _stats_dict(got) == _stats_dict(want)
        merged += sum(not c.active for c in got.individual_cluster_stats.values())
    assert merged > 0  # some clusters merged


@pytest.mark.parametrize("kw", [dict(), dict(lsd_method="lsd_cs", lsd_order=2)], ids=["lsd0", "lsd_cs2"])
def test_bplsd_statistics_match_jax(surface5_rows, kw):
    """``BpLsdDecoder.set_do_stats(True, row)`` on surface d=5 rows where
    the LSD stage runs: the port's ``Statistics`` equal JAX's, apart from
    the elapsed time."""
    code, graph, syn, _ = surface5_rows
    args = dict(error_rate=0.08, max_iter=2, bp_method="minimum_sum", ms_scaling_factor=0.625, **kw)
    jd = ldpc_tpu.BpLsdDecoder(code.hx, **args)
    td = ldpc_tpu_torch.BpLsdDecoder(code.hx, **args, device="cpu")
    jd.decode_batch(syn)
    rows = np.flatnonzero(~jd.converge_batch)[:2]
    assert rows.size
    for r in rows:
        jd.set_do_stats(True, row=int(r))
        td.set_do_stats(True, row=int(r))
        want = jd.decode_batch(syn)
        got = td.decode_batch(syn)
        assert (got == want).all()
        assert td.statistics.individual_cluster_stats
        assert _stats_dict(td.statistics) == _stats_dict(jd.statistics)
        assert td.statistics.elapsed_time > 0


def test_bplsd_stats_plumbing():
    """Mirrors the reference's test_stats_reset
    (reference: python_test/test_bplsd.py:169-192): max_iter=1 forces
    LSD, stats fill; a converged decode clears them."""
    H = rep_code(5)
    dec = ldpc_tpu_torch.BpLsdDecoder(
        H, error_rate=0.1, max_iter=1, bp_method="min_sum", ms_scaling_factor=1.0, device="cpu",
    )
    assert dec.do_stats is False
    dec.set_do_stats(True)
    assert dec.do_stats is True
    s = np.array([1, 1, 0, 1], np.uint8)
    dec.decode(s)
    stats = dec.statistics
    assert stats["lsd_order"] == 0
    assert stats["lsd_method"] == 1  # reference OsdMethod enum: OSD_0 == 1
    assert stats.elapsed_time > 0
    assert stats["syndrome"] == list(map(int, s))
    assert len(stats["bit_llrs"]) == H.shape[1]
    assert len(stats["individual_cluster_stats"]) > 0
    assert len(stats["global_timestep_bit_history"]) > 0
    dec.set_additional_stat_fields([0], [1], [0])
    assert dec.statistics.error == [0]
    dec.reset_cluster_stats()
    assert dec.statistics.syndrome == []
    assert isinstance(dec.statistics.to_json(), str)
    # a decode the BP stage converges on resets the stats
    # (_bplsd_decoder.pyx:146-150)
    dec2 = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=20, device="cpu")
    dec2.set_do_stats(True)
    dec2.decode(np.array([1, 0, 0, 0], np.uint8))
    assert dec2.statistics["individual_cluster_stats"] == {}


def test_bplsd_stats_content():
    """Per-cluster records carry real growth history: two separated flipped
    checks on a rep code form two clusters that grow and merge or validate;
    every active cluster has a consistent solution and size history
    (reference semantics: lsd.hpp:652-816)."""
    H = rep_code(12)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=1, bits_per_step=1,
                                      always_run_lsd=True, device="cpu")
    dec.set_do_stats(True)
    e = np.zeros(12, np.uint8)
    e[3] = 1
    e[7] = 1
    s = (Hd @ e % 2).astype(np.uint8)
    out = dec.decode(s)
    assert np.array_equal(Hd @ out % 2, s)
    stats = dec.statistics
    clusters = stats["individual_cluster_stats"]
    # one cluster per flipped syndrome check (lsd.hpp:702-712)
    assert set(clusters.keys()) == set(map(int, np.flatnonzero(s)))
    active = [c for c in clusters.values() if c.active]
    assert active, "at least one cluster survives"
    for cid, cs in clusters.items():
        assert cs.cluster_id == cid
        assert cs.size_history[0] == 0  # created empty
        if cs.active:
            assert cs.got_valid_in_timestep >= 0
            assert cs.final_bit_count == len(cs.final_bits) > 0
            assert len(cs.solution) == cs.final_bit_count
            assert cs.solution == [int(out[b]) for b in cs.final_bits]
            assert cs.nr_of_non_zero_check_matrix_entries > 0
            assert 0.0 <= cs.cluster_pcm_sparsity < 1.0
        else:
            assert cs.absorbed_by_cluster in clusters
            assert cs.got_inactive_in_timestep >= 0
    added_bits = sorted(
        b
        for per in stats["global_timestep_bit_history"].values()
        for bits in per.values()
        for b in bits
    )
    final_bits = sorted(b for c in clusters.values() for b in (c.final_bits if c.active else []))
    assert set(final_bits) <= set(added_bits)
    j = json.loads(dec.statistics.to_json())
    assert "elapsed_time_mu" in j
    assert j["individual_cluster_stats"]


def test_bplsd_stats_row_selection():
    """``set_do_stats(True, row=k)`` records statistics for batch row k."""
    H = rep_code(12)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=1, bits_per_step=1,
                                      always_run_lsd=True, device="cpu")
    dec.set_do_stats(True, row=2)
    assert dec.stats_row == 2
    errs = np.zeros((3, 12), np.uint8)
    errs[0, 1] = 1
    errs[1, 5] = 1
    errs[2, 3] = 1
    errs[2, 8] = 1
    syn = (errs @ Hd.T % 2).astype(np.uint8)
    out = dec.decode_batch(syn)
    stats = dec.statistics
    assert stats.stats_row == 2
    assert stats["syndrome"] == list(map(int, syn[2]))
    clusters = stats["individual_cluster_stats"]
    assert set(clusters.keys()) == set(map(int, np.flatnonzero(syn[2])))
    for cs in clusters.values():
        if cs.active:
            assert cs.solution == [int(out[2][b]) for b in cs.final_bits]
    with pytest.raises(ValueError):
        dec.set_do_stats(True, row=-1)


def test_stats_json_global_history_shape():
    """``to_json`` mirrors the reference serializer's shape for
    global_timestep_bit_history (lsd.hpp:583-599)."""
    H = rep_code(10)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=1, bits_per_step=1,
                                      always_run_lsd=True, device="cpu")
    dec.set_do_stats(True)
    e = np.zeros(10, np.uint8)
    e[4] = 1
    s = (Hd @ e % 2).astype(np.uint8)
    dec.decode(s)
    d = json.loads(dec.statistics.to_json())
    assert "elapsed_time_mu" in d
    hist = d["global_timestep_bit_history"]
    assert hist, "history must be populated"
    for ts, per_cluster in hist.items():
        int(ts)
        assert isinstance(per_cluster, dict)
        for cid, bits in per_cluster.items():
            int(cid)
            assert isinstance(bits, list)
            assert all(isinstance(b, int) for b in bits)
