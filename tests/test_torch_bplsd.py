"""BpLsdDecoder of the port held against the JAX package's, and the
API-parity probes of the JAX package's LSD tests (tests/test_lsd_decoder.py)
that need no statistics.

Syndromes are made with numpy from a seed and fed to both decoders; the
JAX side runs on the CPU. On the CPU the port runs each kernel's plain
PyTorch version. LSD's candidate keys are integers, so the decodings must
be equal, tie or not.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ldpc_tpu
import ldpc_tpu_torch
from ldpc_tpu.codes import hamming_code, rep_code, surface_code

torch.set_num_threads(1)

KW = dict(max_iter=30, bp_method="minimum_sum", ms_scaling_factor=0.625)


def _all_syndromes(m):
    return ((np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)


@pytest.fixture(scope="module")
def d13():
    hx = surface_code(13).hx
    H = np.asarray(hx.todense(), np.uint8)
    rng = np.random.default_rng(7)
    errors = (rng.random((1024, H.shape[1])) < 0.01).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    syn[3] = 0  # a zero-syndrome row
    return hx, H, syn


@pytest.mark.parametrize("kw", [dict(lsd_method="lsd_0"), dict(lsd_method="lsd_cs", lsd_order=5)],
                         ids=["lsd0", "lsd_cs5"])
def test_bplsd_decode_batch_matches_jax(d13, kw):
    """The slice end to end: ``BpLsdDecoder`` on 1,024 d=13 syndromes,
    against the JAX decoder, exactly."""
    hx, H, syn = d13
    jd = ldpc_tpu.BpLsdDecoder(hx, error_rate=0.01, **KW, **kw)
    td = ldpc_tpu_torch.BpLsdDecoder(hx, error_rate=0.01, **KW, **kw, device="cpu")
    want = jd.decode_batch(syn)
    got = td.decode_batch(syn)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).all()
    assert (td.converge_batch == jd.converge_batch).all()
    assert (td.iter_batch == jd.iter_batch).all()
    assert ((got @ H.T) % 2 == syn).all()
    assert (~td.converge_batch).sum() > 50  # LSD really ran
    assert (td.decoding == want[0]).all()
    assert td.converge == jd.converge and td.iter == jd.iter
    assert (td.bp_decoding == jd.bp_decoding).all()
    np.testing.assert_allclose(
        td.log_prob_ratios_batch, np.asarray(jd.log_prob_ratios_batch), rtol=1e-6, atol=1e-6
    )


def test_bplsd_surface_code_and_bit_packed_io():
    """tests/test_lsd_decoder.py's surface-code case, then bit-packed in
    and out."""
    code = surface_code(5)
    H = np.asarray(code.hx.todense(), np.uint8)
    rng = np.random.default_rng(149)
    errors = (rng.random((128, H.shape[1])) < 0.05).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    kw = dict(error_rate=0.05, max_iter=5, bp_method="minimum_sum", ms_scaling_factor=0.625,
              bits_per_step=1, lsd_method="lsd_cs", lsd_order=3)
    dec = ldpc_tpu_torch.BpLsdDecoder(code.hx, **kw, device="cpu")
    out = dec.decode_batch(syn)
    assert ((out @ H.T) % 2 == syn).all()
    assert (~dec.converge_batch).any()
    packed = np.packbits(syn, axis=1, bitorder="little")
    assert (dec.decode_batch(packed, bit_packed_syndromes=True) == out).all()
    got = dec.decode_batch(packed, bit_packed_syndromes=True, bit_packed_output=True)
    assert (got == np.packbits(out, axis=1, bitorder="little")).all()
    with pytest.raises(ValueError, match="Bit-packed"):
        dec.decode_batch(np.zeros((4, 99), np.uint8), bit_packed_syndromes=True)


@pytest.mark.parametrize("kw", [dict(), dict(lsd_method="lsd_cs", lsd_order=3),
                                dict(lsd_method="lsd_e", lsd_order=3)],
                         ids=["lsd0", "lsd_cs3", "lsd_e3"])
def test_bplsd_hamming_exhaustive(kw):
    """Every syndrome of the [7,4] Hamming code, through the LSD stage
    (``always_run_lsd``), in one batch and one at a time: valid, and the
    same either way (tests/test_torch_lsd.py holds the LSD stage to JAX
    on the same sweep)."""
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    syn = _all_syndromes(3)
    args = dict(error_rate=0.1, max_iter=5, bits_per_step=1, always_run_lsd=True, **kw)
    td = ldpc_tpu_torch.BpLsdDecoder(H, **args, device="cpu")
    out = td.decode_batch(syn)
    assert ((out @ Hd.T) % 2 == syn).all()
    assert td.converge_batch[0] and not out[0].any()
    for s, row in zip(syn, out):
        assert (td.decode(s) == row).all()


def test_bplsd_osd_compat_kwargs():
    dec = ldpc_tpu_torch.BpLsdDecoder(rep_code(10), error_rate=0.1, osd_method="osd_cs", osd_order=2, device="cpu")
    assert dec.lsd_method == "LSD_CS"
    assert dec.lsd_order == 2
    assert dec.bits_per_step == 1
    assert ldpc_tpu_torch.BpLsdDecoder(rep_code(10), error_rate=0.1, bits_per_step=0, device="cpu").bits_per_step == 10


def test_bplsd_validation():
    D = functools.partial(ldpc_tpu_torch.BpLsdDecoder, device="cpu")
    with pytest.raises(ValueError):
        D(rep_code(10), error_rate=0.1, lsd_order=-1)
    with pytest.raises(ValueError):
        D(rep_code(10), error_rate=0.1, lsd_method="bogus")
    with pytest.raises(TypeError):
        D([[1, 1, 0], [0, 1, 1]], error_rate=0.1)
    dec = D(rep_code(10), error_rate=0.1)
    assert (dec.lsd_method, dec.lsd_order) == ("LSD_0", 0)
    with pytest.raises(ValueError):
        dec.lsd_order = 2  # method is LSD_0
    for alias, name in (("lsd_e", "LSD_E"), ("e", "LSD_E"), ("cs", "LSD_CS"), ("osd_0", "LSD_0"),
                        ("off", "LSD_OFF")):
        assert D(rep_code(10), error_rate=0.1, lsd_method=alias).lsd_method == name
    with pytest.warns(UserWarning):
        D(rep_code(10), error_rate=0.1, lsd_method="lsd_e", lsd_order=16)
    with pytest.raises(ValueError):
        dec.decode(np.zeros(5, np.uint8))
    with pytest.raises(ValueError):
        dec.decode_batch(np.zeros((2, 5), np.uint8))


def test_bplsd_always_run_lsd():
    H = rep_code(10)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=20, always_run_lsd=True, bits_per_step=1, device="cpu")
    e = np.zeros(10, np.uint8)
    e[4] = 1
    s = (Hd @ e % 2).astype(np.uint8)
    out = dec.decode(s)
    assert np.array_equal(Hd @ out % 2, s)
    assert dec.converge  # BP converged; LSD ran all the same


def test_bplsd_zero_syndrome():
    dec = ldpc_tpu_torch.BpLsdDecoder(rep_code(5), error_rate=0.1, device="cpu")
    x = dec.decode(np.zeros(4, np.uint8))
    assert not x.any() and dec.converge


def test_bplsd_stats_plumbing_without_cluster_stats():
    """The statistics surface with statistics off and on: off, a decode
    whose LSD stage runs records nothing per cluster; on, it records the
    clusters (tests/test_torch_lsd_standalone.py holds them to JAX's)."""
    H = rep_code(5)
    dec = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=1, bp_method="min_sum",
                                      ms_scaling_factor=1.0, device="cpu")
    assert dec.do_stats is False
    s = np.array([1, 1, 0, 1], np.uint8)
    dec.decode(s)  # stats off: LSD runs and nothing is recorded
    stats = dec.statistics
    assert stats["lsd_order"] == 0 and stats["lsd_method"] == 1
    assert stats.elapsed_time > 0
    assert stats["individual_cluster_stats"] == {}
    dec.set_do_stats(True)
    assert dec.do_stats is True and dec.stats_row == 0
    dec.decode(s)
    assert set(dec.statistics["individual_cluster_stats"]) == {0, 1, 3}
    dec.set_additional_stat_fields([0], [1], [0])
    assert dec.statistics.error == [0] and dec.statistics.syndrome == [1]
    dec.reset_cluster_stats()
    assert dec.statistics.syndrome == []
    assert isinstance(dec.statistics.to_json(), str)
    with pytest.raises(ValueError):
        dec.set_do_stats(True, row=-1)
    # a decode the BP stage converges on needs no statistics
    dec2 = ldpc_tpu_torch.BpLsdDecoder(H, error_rate=0.1, max_iter=20, device="cpu")
    dec2.set_do_stats(True)
    dec2.decode(np.array([1, 0, 0, 0], np.uint8))
    assert dec2.statistics["individual_cluster_stats"] == {}


def test_bplsd_imports_no_jax():
    """A fresh process imports the port, decodes on the CPU with every
    decoder of the port (BpLsdDecoder at order 0 and 3 with statistics,
    BpOsdDecoder, UnionFindDecoder in both modes, BeliefFindDecoder,
    LsdDecoder, FlipDecoder, BpFlipDecoder, BpDecoder with every schedule,
    float64, single-scan, SoftInfoBpDecoder, SoftInfoBpOsdDecoder, one
    device Monte-Carlo step, MbpDecoder in both input forms with its
    union-find fallback, float64 BpLsdDecoder, BeliefFindDecoder,
    BpFlipDecoder and single-scan), builds and runs the window decoder
    (OSD-0, LSD-0 and analog), a QSS step in binary and analog mode,
    DeviceQss, QssSimulator and MonteCarloBscSimulation, imports the host
    modules ``mod2``, ``code_util``, ``alist``, ``protograph`` and
    ``noise_models``, and never imports jax or any module of the JAX package
    ``ldpc_tpu``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, numpy as np\n"
        "import ldpc_tpu_torch\n"
        "from ldpc_tpu_torch.codes import surface_code\n"
        "code = surface_code(3)\n"
        "H = np.asarray(code.hx.todense(), np.uint8)\n"
        "s = (np.eye(1, H.shape[1], 4, dtype=np.uint8) @ H.T % 2)[0]\n"
        "for kw in ({}, {'lsd_method': 'lsd_cs', 'lsd_order': 3}):\n"
        "    d = ldpc_tpu_torch.BpLsdDecoder(code.hx, error_rate=0.1, max_iter=1,\n"
        "                                    always_run_lsd=True, device='cpu', **kw)\n"
        "    d.set_do_stats(True)\n"
        "    x = d.decode(s)\n"
        "    assert ((H @ x) % 2 == s).all() and d.statistics.individual_cluster_stats\n"
        "for uf_method in (True, False):\n"
        "    x = ldpc_tpu_torch.UnionFindDecoder(code.hx, uf_method=uf_method,\n"
        "                                     device='cpu').decode(s)\n"
        "    assert ((H @ x) % 2 == s).all()\n"
        "for uf_method in ('inversion', 'peeling'):\n"
        "    d = ldpc_tpu_torch.BeliefFindDecoder(code.hx, error_rate=0.1, max_iter=1,\n"
        "                                         uf_method=uf_method, device='cpu')\n"
        "    assert ((H @ d.decode(s)) % 2 == s).all()\n"
        "d = ldpc_tpu_torch.LsdDecoder(code.hx, lsd_method='lsd_cs', lsd_order=2,\n"
        "                              device='cpu')\n"
        "assert ((H @ d.decode(s, np.ones(H.shape[1]))) % 2 == s).all()\n"
        "d = ldpc_tpu_torch.FlipDecoder(code.hx, pfreq=2, seed=1, device='cpu')\n"
        "x = d.decode(s)\n"
        "assert d.converge and ((H @ x) % 2 == s).all()\n"
        "d = ldpc_tpu_torch.BpFlipDecoder(code.hx, error_rate=0.1, max_iter=5, device='cpu')\n"
        "assert ((H @ d.decode(s)) % 2 == s).all()\n"
        "d = ldpc_tpu_torch.BpOsdDecoder(code.hx, error_rate=0.1, max_iter=1,\n"
        "                                osd_method='osd_cs', osd_order=3, device='cpu')\n"
        "assert ((H @ d.decode(s)) % 2 == s).all()\n"
        "d = ldpc_tpu_torch.BpDecoder(code.hx, error_rate=0.1, max_iter=5, device='cpu')\n"
        "d.decode(s)\n"
        "d.decode_single_scan(s)\n"
        "for kw in ({'schedule': 'serial'}, {'schedule': 'serial_relative'},\n"
        "           {'schedule': 'serial', 'random_serial_schedule': True},\n"
        "           {'dtype': 'float64'}, {'schedule': 'serial', 'dtype': 'float64'}):\n"
        "    d = ldpc_tpu_torch.BpOsdDecoder(code.hx, error_rate=0.1, max_iter=5,\n"
        "                                    device='cpu', **kw)\n"
        "    assert ((H @ d.decode(s)) % 2 == s).all()\n"
        "soft = np.where(s == 1, -20.0, 20.0)  # confident: no virtual update\n"
        "d = ldpc_tpu_torch.SoftInfoBpDecoder(code.hx, error_rate=0.1, max_iter=5, device='cpu')\n"
        "d.decode(soft)\n"
        "d = ldpc_tpu_torch.SoftInfoBpOsdDecoder(code.hx, error_rate=0.1, max_iter=5,\n"
        "                                        device='cpu')\n"
        "assert ((H @ d.decode(soft)) % 2 == s).all()\n"
        "import torch\n"
        "from ldpc_tpu_torch.monte_carlo_simulation import make_mc_decoder_step\n"
        "step, runs = make_mc_decoder_step(code.hx, 0.05, batch_size=512, max_iter=5,\n"
        "                                  device='cpu')\n"
        "assert int(step(torch.Generator())[0]) == runs\n"
        "for kw in ({'lsd_method': 'lsd_cs', 'lsd_order': 3}, {}):\n"
        "    d = ldpc_tpu_torch.BpLsdDecoder(code.hx, error_rate=0.1, max_iter=1,\n"
        "                                    always_run_lsd=True, dtype='float64',\n"
        "                                    device='cpu', **kw)\n"
        "    d.set_do_stats(True)\n"
        "    assert ((H @ d.decode(s)) % 2 == s).all()\n"
        "for cls in (ldpc_tpu_torch.BeliefFindDecoder, ldpc_tpu_torch.BpFlipDecoder):\n"
        "    d = cls(code.hx, error_rate=0.1, max_iter=5, dtype='float64', device='cpu')\n"
        "    assert ((H @ d.decode(s)) % 2 == s).all()\n"
        "d = ldpc_tpu_torch.BpDecoder(code.hx, error_rate=0.1, max_iter=5, dtype='float64',\n"
        "                             device='cpu')\n"
        "d.decode_single_scan(s)\n"
        "hz = np.asarray(code.hz.todense(), np.uint8)\n"
        "d = ldpc_tpu_torch.MbpDecoder(HX_CSS=H, HZ_CSS=hz, error_rate=0.05, max_iter=10,\n"
        "                              device='cpu')\n"
        "sx = hz @ np.eye(1, H.shape[1], 4, dtype=np.uint8)[0] % 2\n"
        "outx, outz = d.uf_decode(sx=sx, sz=np.zeros(H.shape[0], np.uint8))\n"
        "assert ((hz @ outx) % 2 == sx).all()\n"
        "g = np.vstack([H, 3 * hz]).astype(np.uint8)\n"
        "d = ldpc_tpu_torch.MbpDecoder(Hgf4=g, error_rate=0.05, max_iter=10, bp_method='ms',\n"
        "                              device='cpu')\n"
        "d.decode_batch(np.zeros((2, g.shape[0]), np.uint8))\n"
        "from ldpc_tpu_torch import alist, code_util, mod2, noise_models, protograph\n"
        "assert code_util.compute_exact_code_distance(H) >= 1 and mod2.rank(H) > 0\n"
        "e = noise_models.generate_depolarizing_error_batch(torch.Generator(), 4, 9, 0.1,\n"
        "                                                   device='cpu')\n"
        "assert e.shape == (4, 9) and protograph.permutation_matrix(3, 1).shape == (3, 3)\n"
        "assert callable(alist.save_alist)\n"
        "from ldpc_tpu_torch.parallel import make_window_decoder\n"
        "from ldpc_tpu_torch.monte_carlo_simulation import (DeviceQss, QssSimulator,\n"
        "    MonteCarloBscSimulation, make_qss_step)\n"
        "hist = np.zeros((2, H.shape[0], 8), np.uint8)\n"
        "hist[:, 3, 2:] = 1\n"
        "for kw in ({}, {'postprocess': 'lsd0'}, {'sigma': 0.5}):\n"
        "    win = make_window_decoder(code.hx, 4, 0.01, 0.01, max_iter=5, device='cpu', **kw)\n"
        "    r = win(hist, 1.0 - 2.0 * hist if 'sigma' in kw else None)\n"
        "    assert r.correction.shape == (2, H.shape[1])\n"
        "lx = np.asarray(code.lx.todense(), np.uint8)\n"
        "for analog in (False, True):\n"
        "    step, runs = make_qss_step(code.hx, 0.02, 0.02, lx, repetitions=4, rounds=8,\n"
        "                               batch_size=8, max_iter=5, analog_tg=analog,\n"
        "                               device='cpu')\n"
        "    assert int(step(torch.Generator())[0]) == runs\n"
        "assert DeviceQss(code.hx, 0.02, 0.02, lx, repetitions=4, rounds=8, batch_size=8,\n"
        "                 max_iter=5, device='cpu').run(8)['nr_runs'] == 8\n"
        "QssSimulator(H, 0.02, 0.02, lx, [1, 1, 1], repetitions=4, rounds=8,\n"
        "             bp_params=None, device='cpu').run(2)\n"
        "d = ldpc_tpu_torch.BpOsdDecoder(code.hx, error_rate=0.05, max_iter=5, device='cpu')\n"
        "MonteCarloBscSimulation(H, 0.05, d, target_run_count=4, tqdm_disable=True,\n"
        "                        seed=1).run()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = sorted(m for m in sys.modules if m == 'ldpc_tpu' or m.startswith('ldpc_tpu.'))\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=repo, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
