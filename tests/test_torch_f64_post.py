"""The float64 post-processing decoders against the JAX package's at
``jnp.float64``: BP+LSD (LSD-0, LSD-CS-5, with statistics), BeliefFind
(inversion and peeling) and BP+flip, on surface d=5 and a slice of the d=13
workload; and single-scan BP's float64 plain version against
``make_single_scan_decoder(..., dtype=jnp.float64)``. Bit for bit: BP runs
K8''s plain version (float64, full depth, no cascade) on both sides of the
comparison, as JAX runs its exact engine; LSD's growth keys are float32
(JAX's ``make_lsd_decoder`` default, which its ``BpLsdDecoder`` keeps) and
union-find's too; the statistics replay rounds the row's LLRs to float32
and holds them in float64, as JAX's ``compute_lsd_statistics`` does.

BeliefFind's peeling mode is compared with the JAX package on its fused
cluster-solver path (``make_masked_solver_or_none`` patched to the
interpret-mode Pallas solver, as ``tests/test_torch_uf.py`` does): on the
CPU its default is a BFS-forest peel that may pick another valid
solution.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import surface_code
from ldpc_tpu.ops import bp as jbp
from ldpc_tpu.ops import pcm as jpcm
from ldpc_tpu.ops import uf as juf
from ldpc_tpu.ops.gf2_pallas import make_masked_solver
from ldpc_tpu_torch.ops import bp as tbp
from ldpc_tpu_torch.ops import pcm as tpcm

torch.set_num_threads(1)

KW = dict(max_iter=30, bp_method="minimum_sum", ms_scaling_factor=0.625)


@functools.lru_cache(maxsize=None)
def workload(d):
    """(hx, H, syndromes, p): surface d=5 at p=0.06 (300 rows) or the first
    256 rows of the d=13 workload's kind at p=0.02."""
    B, p = (300, 0.06) if d == 5 else (256, 0.02)
    hx = surface_code(d).hx
    H = np.asarray(hx.todense(), np.uint8)
    rng = np.random.default_rng(7)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    syn[3] = 0  # a zero-syndrome row
    return hx, H, syn, p


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package on its fused cluster-solver path, with the Pallas
    masked solver in interpret mode."""
    monkeypatch.setattr(
        juf, "make_masked_solver_or_none",
        lambda graph, dtype: make_masked_solver(graph, interpret=True),
    )


def _pair(cls, hx, p, **kw):
    return (getattr(ldpc_tpu, cls)(hx, error_rate=p, dtype=jnp.float64, **KW, **kw),
            getattr(ldpc_tpu_torch, cls)(hx, error_rate=p, dtype=torch.float64, **KW, **kw,
                                         device="cpu"))


def _assert_same_batch(jd, td, want, got, H, syn, solves=True):
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(td.converge_batch, jd.converge_batch)
    np.testing.assert_array_equal(td.iter_batch, jd.iter_batch)
    assert (~td.converge_batch).sum() > 3  # the post-processor really ran
    if solves:
        assert ((got.astype(np.int64) @ H.T) % 2 == syn).all()


@pytest.mark.parametrize("kw", [dict(lsd_method="lsd_0"), dict(lsd_method="lsd_cs", lsd_order=5)],
                         ids=["lsd0", "lsd_cs5"])
@pytest.mark.parametrize("d", [5, 13])
def test_bplsd_float64_matches_jax(d, kw):
    hx, H, syn, p = workload(d)
    jd, td = _pair("BpLsdDecoder", hx, p, **kw)
    want, got = jd.decode_batch(syn), td.decode_batch(syn)
    _assert_same_batch(jd, td, want, got, H, syn)
    np.testing.assert_array_equal(td.log_prob_ratios_batch, np.asarray(jd.log_prob_ratios_batch))
    assert td.log_prob_ratios_batch.dtype == np.float64
    np.testing.assert_array_equal(td.bp_decoding, jd.bp_decoding)


@pytest.mark.parametrize("kw", [dict(), dict(lsd_method="lsd_cs", lsd_order=5)],
                         ids=["lsd0", "lsd_cs5"])
def test_bplsd_float64_statistics_match_jax(kw):
    """``set_do_stats(True, row)`` in float64 on rows where LSD runs: the
    port's ``Statistics`` (bit LLRs in float64 included) equal JAX's,
    apart from the elapsed time."""
    hx, _, syn, p = workload(5)
    jd, td = _pair("BpLsdDecoder", hx, p, **kw)
    jd.decode_batch(syn)
    rows = np.flatnonzero(~jd.converge_batch)[:2]
    assert rows.size
    for r in rows:
        jd.set_do_stats(True, row=int(r))
        td.set_do_stats(True, row=int(r))
        np.testing.assert_array_equal(td.decode_batch(syn), jd.decode_batch(syn))
        t, j = dataclasses.asdict(td.statistics), dataclasses.asdict(jd.statistics)
        t.pop("elapsed_time"), j.pop("elapsed_time")
        assert t["individual_cluster_stats"] and t == j


@pytest.mark.parametrize("uf_method", ["inversion", "peeling"])
@pytest.mark.parametrize("d", [5, 13])
def test_belief_find_float64_matches_jax(fused_jax, d, uf_method):
    hx, H, syn, p = workload(d)
    jd, td = _pair("BeliefFindDecoder", hx, p, uf_method=uf_method)
    want, got = jd.decode_batch(syn), td.decode_batch(syn)
    _assert_same_batch(jd, td, want, got, H, syn)


@pytest.mark.parametrize("d", [5, 13])
def test_bp_flip_float64_matches_jax(d):
    """JAX's BpFlip takes its host path in float64 (flip, then its exact
    engine on the residual); H x = s holds on the converged rows."""
    hx, H, syn, p = workload(d)
    jd, td = _pair("BpFlipDecoder", hx, p, flip_iterations=0)
    want, got = jd.decode_batch(syn), td.decode_batch(syn)
    _assert_same_batch(jd, td, want, got, H, syn, solves=False)
    conv = td.converge_batch
    assert ((got[conv].astype(np.int64) @ H.T) % 2 == syn[conv]).all()
    np.testing.assert_array_equal(td.log_prob_ratios, jd.log_prob_ratios)


@pytest.mark.parametrize("alpha", [0.625, 0.0])
@pytest.mark.parametrize("d", [5, 13])
def test_single_scan_float64_matches_jax(d, alpha):
    """K1''s plain version in float64 with its factor fixed against JAX's
    single-scan engine at float64: decisions, posteriors, flags and
    iterations bit for bit."""
    hx, _, syn, p = workload(d)
    llr = np.full(hx.shape[1], np.log((1 - p) / p))
    rj = jbp.make_single_scan_decoder(jpcm.compile_pcm(hx), 30, alpha, dtype=jnp.float64)(
        jnp.asarray(syn), jnp.asarray(llr))
    rt = tbp.make_single_scan_decoder(tpcm.compile_pcm(hx), 30, alpha, "cpu",
                                      dtype=torch.float64)(syn, llr)
    assert rt.llr_posterior.dtype == torch.float64
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_decode_single_scan_float64_matches_jax():
    """``BpDecoder(dtype=float64).decode_single_scan`` a syndrome at a time,
    with its properties, as the JAX decoder's."""
    hx, _, syn, p = workload(5)
    jd, td = _pair("BpDecoder", hx, p)
    for s in syn[:40]:
        np.testing.assert_array_equal(td.decode_single_scan(s), jd.decode_single_scan(s))
        assert (td.converge, td.iter) == (jd.converge, jd.iter)
        np.testing.assert_array_equal(td.log_prob_ratios, np.asarray(jd.log_prob_ratios))
