"""The port's sinter front end (``ldpc_tpu_torch.sinter_decoders`` and
``ldpc_tpu_torch.ckt_noise.sinter_overlapping_window_decoder``) held
against the JAX package's on the CPU, on duck-typed detector error models
(sinter and stim are not installed; the adapters import them lazily).

- ``decode_batch_from_dem`` and ``compile_decoder_for_dem(dem=...)
  .decode_shots_bit_packed`` of ``SinterBpOsdDecoder``,
  ``SinterLsdDecoder`` and ``SinterBeliefFindDecoder``: predictions equal
  on every shot, packed and unpacked, but for OSD-w ties (another
  solution of the same weight, ROADMAP queue 3: shot 103 of BP+OSD-CS 3
  here, both corrections weighing 27.38416103799702).
- The packed path: stim's little-endian b8 rows unpack to the same
  detector bits on both sides, trailing pad bits ignored.
- ``decode_via_files`` needs stim; ``ldpc_tpu_torch.SinterBpOsdDecoder``.
(The overlapping-window adapters: tests/test_torch_ckt_noise.py.)
"""

import numpy as np
import pytest
import torch

import ldpc_tpu.sinter_decoders as JS
import ldpc_tpu_torch
import ldpc_tpu_torch.ckt_noise.sinter_overlapping_window_decoder as TOWD
import ldpc_tpu_torch.sinter_decoders as TS
from ldpc_tpu.decoders.bposd_decoder import BpOsdDecoder as JBpOsd
from ldpc_tpu_torch.ckt_noise import detector_error_model_to_check_matrices
from test_torch_ckt_noise import surface_memory_dem

torch.set_num_threads(1)

# 60 detectors: not a whole number of bytes, so a packed row has pad bits
DEM_ROUNDS = 3


def _shots(B=128, seed=6):
    """(dem, shots (B, 60) uint8, observable flips (B, 1)) of the surface
    d=5 memory DEM over 3 rounds at p=0.02, errors drawn from its priors."""
    dem, _ = surface_memory_dem(d=5, rounds=DEM_ROUNDS, p=0.02, q=0.02)
    mats = detector_error_model_to_check_matrices(dem)
    rng = np.random.default_rng(seed)
    errs = (rng.random((B, mats.check_matrix.shape[1])) < mats.priors).astype(np.uint8)
    shots = (errs @ mats.check_matrix.T.toarray() % 2).astype(np.uint8)
    obs = (errs @ mats.observables_matrix.T.toarray() % 2).astype(np.uint8)
    return dem, shots, obs


ADAPTERS = {
    "bposd": ("SinterBpOsdDecoder", {}),
    "bposd_cs": ("SinterBpOsdDecoder", {"osd_method": "osd_cs", "osd_order": 3, "max_iter": 20}),
    "lsd": ("SinterLsdDecoder", {}),
    "lsd_cs": ("SinterLsdDecoder", {"lsd_method": "lsd_cs", "lsd_order": 2, "max_iter": 20}),
    "belief_find": ("SinterBeliefFindDecoder", {}),
    "belief_find_peeling": ("SinterBeliefFindDecoder", {"uf_method": "peeling", "max_iter": 20}),
}


def _osd_w_ties(t, j, dem, shots) -> np.ndarray:
    """The shots on which the two adapters' decoders return different
    corrections, each held to be a tie: both solve the shot's detectors
    and weigh the same, sum(log(1/p)) over their mechanisms."""
    mats = detector_error_model_to_check_matrices(dem)
    H = mats.check_matrix.tocsr()
    ct = t._make_decoder(H, mats.priors).decode_batch(shots)
    cj = np.asarray(j._make_decoder(H, mats.priors).decode_batch(shots))
    ties = np.flatnonzero((ct != cj).any(axis=1))
    weight = np.log(1.0 / mats.priors)
    for r in ties:
        assert np.array_equal(H @ ct[r] % 2, shots[r]) and np.array_equal(H @ cj[r] % 2, shots[r])
        assert np.isclose(weight[ct[r] == 1].sum(), weight[cj[r] == 1].sum(), rtol=1e-12)
    return ties


@pytest.mark.parametrize("name", list(ADAPTERS))
def test_sinter_adapter_matches_jax(name):
    cls, kw = ADAPTERS[name]
    dem, shots, obs = _shots()
    t = getattr(TS, cls)(device="cpu", **kw)
    j = getattr(JS, cls)(**kw)
    pt = t.decode_batch_from_dem(dem, shots)
    pj = j.decode_batch_from_dem(dem, shots)
    assert pt.dtype == np.uint8 and pt.shape == (shots.shape[0], 1)
    ties = _osd_w_ties(t, j, dem, shots) if name.endswith("_cs") else []
    assert len(ties) <= 1
    keep = np.setdiff1d(np.arange(shots.shape[0]), ties)
    assert np.array_equal(pt[keep], pj[keep])
    assert (pt == obs).all(axis=1).mean() > 0.9
    packed = np.packbits(shots, axis=1, bitorder="little")
    ct = t.compile_decoder_for_dem(dem=dem)
    out = ct.decode_shots_bit_packed(bit_packed_detection_event_data=packed)
    assert out.dtype == np.uint8 and out.shape == (shots.shape[0], 1)
    want = j.compile_decoder_for_dem(dem=dem).decode_shots_bit_packed(
        bit_packed_detection_event_data=packed)
    assert np.array_equal(out[keep], want[keep])
    assert np.array_equal(out, np.packbits(pt, axis=1, bitorder="little"))
    assert ct.decoder.device == torch.device("cpu")


def test_packed_unpacking_matches_jax():
    """stim's b8 rows, with garbage in the pad bits past the 60th, unpack to
    the same bits in the port's decoders as in the JAX package's."""
    dem, shots, _ = _shots(B=32)
    mats = detector_error_model_to_check_matrices(dem)
    packed = np.packbits(shots, axis=1, bitorder="little")
    packed[:, -1] |= 0xF0  # bits 60-63: padding
    t = ldpc_tpu_torch.BpOsdDecoder(mats.check_matrix.tocsr(), error_channel=list(mats.priors),
                                    max_iter=10, device="cpu")
    j = JBpOsd(mats.check_matrix.tocsr(), error_channel=list(mats.priors), max_iter=10)
    got = t._coerce_batch_syndromes(packed, True)
    assert np.array_equal(got, shots)
    assert np.array_equal(got, j._coerce_batch_syndromes(packed, True))
    assert np.array_equal(t.decode_batch(packed, bit_packed_syndromes=True),
                          np.asarray(j.decode_batch(packed, bit_packed_syndromes=True)))
    with pytest.raises(ValueError, match="Bit-packed"):
        t.decode_batch(packed[:, :-1], bit_packed_syndromes=True)


def test_file_entry_points_need_stim():
    """``decode_via_files`` imports stim when called, as the JAX package's
    does; without it both raise ImportError."""
    for adapter in (TS.SinterBpOsdDecoder(device="cpu"),
                    TOWD.SinterDecoder_BPOSD_OWD(decodings=6, window=4, commit=2,
                                                 num_checks=3, device="cpu")):
        with pytest.raises(ImportError):
            adapter.decode_via_files(
                num_shots=1, num_dets=1, num_obs=1, dem_path="x.dem",
                dets_b8_in_path="x.b8", obs_predictions_b8_out_path="y.b8", tmp_dir=".")


def test_root_export():
    assert ldpc_tpu_torch.SinterBpOsdDecoder is TS.SinterBpOsdDecoder
    assert "SinterBpOsdDecoder" in ldpc_tpu_torch.__all__
    assert ldpc_tpu_torch.sinter_decoders is TS
    with pytest.raises(AttributeError):
        ldpc_tpu_torch.SinterNoSuchDecoder  # noqa: B018
