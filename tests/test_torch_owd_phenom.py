"""The port's ``BpOsdOverlappingWindowDecoder`` held against the
benchmark's plain reference on a small phenomenological memory experiment
(``benchmark/reference/phenom.py`` and ``owd.py``), on the CPU:

- the reference's matrices, observable and priors equal the port's
  conversion of the same model given behind stim's instruction interface,
  and its d=13 observable is row 0 of the port's ``surface_code(13).lx``;
- the corrections equal lane for lane, through the device windows and
  through the forced host loop, and every shot's correction x reproduces
  its detectors (H x = s);
- ``decode_batch(..., return_corrections=True)`` returns the corrections of
  ``_corr_multiple_rounds_batch``, bit-packed little-endian with
  ``bit_packed_predictions``, and the default return is unchanged for both
  BP families;
- the resident path's arithmetic equals the numpy loop's on the same
  window decodings (a stand-in window decoder that echoes its syndromes),
  2s included.

The small experiment: the unrotated d=5 surface code over 10 rounds at
p = q = 0.02, windows of 4 rounds committing 2, so 4 decodings and the
device windows 1 and 2 (the device scan needs at least 4 decodings to
measure its column stride between two middle windows).
"""

import warnings

import numpy as np
import pytest
import torch

import ldpc_tpu_torch.ckt_noise as T
from benchmark.reference import owd as ref
from benchmark.reference import phenom
from ldpc_tpu_torch.codes import surface_code

torch.set_num_threads(1)

D, ROUNDS, P, B = 5, 10, 0.02, 96
OWD = dict(decodings=4, window=4, commit=2)


def _experiment(seed=7):
    """(Phenom, the stim-like model, shots (B, detectors) uint8)."""
    dem = phenom.surface_memory(D, ROUNDS, P, P)
    rng = np.random.default_rng(seed)
    errs = (rng.random((B, dem.H.shape[1])) < dem.priors).astype(np.uint8)
    shots = (errs @ dem.H.T % 2).astype(np.uint8)
    return dem, phenom.StimLikeDem.surface_memory(D, ROUNDS, P, P), shots


def _decoder(model, path, family=T.BpOsdOverlappingWindowDecoder):
    dec = family(model, num_checks=model.num_checks, device="cpu", **OWD)
    if path == "host":
        dec._device_scan = None
    else:
        uw = dec._maybe_device_scan()[0]
        assert (uw.w_lo, uw.w_hi) == (1, 3)
    return dec


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the host loop's warning
        return fn(*args, **kwargs)


_REFERENCE = {}


def _reference(dem, shots):
    if "x" not in _REFERENCE:
        _REFERENCE["x"] = ref.decode(dem.H, dem.priors, torch.from_numpy(shots),
                                     OWD["decodings"], OWD["window"], OWD["commit"],
                                     dem.num_checks, 30, 1.0)
    return _REFERENCE["x"]


@pytest.mark.parametrize("d,rounds", [(5, 10), (13, 16)])
def test_matrices_equal_the_ports_conversion(d, rounds):
    dem = phenom.surface_memory(d, rounds, 0.003, 0.002)
    mats = T.detector_error_model_to_check_matrices(
        phenom.StimLikeDem.surface_memory(d, rounds, 0.003, 0.002))
    assert mats.check_matrix.shape == dem.H.shape == (rounds * (d - 1) * d,
                                                      rounds * (d * d + (d - 1) ** 2)
                                                      + (rounds - 1) * (d - 1) * d)
    assert (mats.check_matrix.toarray() == dem.H).all()
    assert (mats.observables_matrix.toarray() == dem.obs).all()
    assert np.array_equal(mats.priors, dem.priors)
    assert sorted(set(dem.priors)) == [0.002, 0.003]


def test_observable_is_the_ports_logical_at_d13():
    lx = np.asarray(surface_code(13).lx.todense(), np.uint8)[0]
    assert np.array_equal(lx, phenom.surface_logical(13))


@pytest.mark.parametrize("path", ["device", "host"])
def test_corrections_equal_the_reference(path):
    dem, model, shots = _experiment()
    want, work = _reference(dem, shots)
    got = _quiet(_decoder(model, path)._corr_multiple_rounds_batch, shots.copy())
    assert got.dtype == np.uint8
    assert np.flatnonzero((got != want.numpy()).any(axis=1)).tolist() == []
    # OSD-0 decodes in every window, the device windows included
    assert all(w["osd_lanes"] > 0 for w in work) and len(work) == OWD["decodings"]


@pytest.mark.parametrize("side", ["port", "reference"])
def test_every_correction_reproduces_its_detectors(side):
    dem, model, shots = _experiment()
    if side == "port":
        x = _decoder(model, "device")._corr_multiple_rounds_batch(shots.copy())
    else:
        x = _reference(dem, shots)[0].numpy()
    assert ((x.astype(np.int64) @ dem.H.T % 2) == shots).all()


@pytest.mark.parametrize("packed", [False, True])
def test_return_corrections(packed):
    dem, model, shots = _experiment()
    dec = _decoder(model, "device")
    corr = dec._corr_multiple_rounds_batch(shots.copy())
    x = np.packbits(shots, axis=1, bitorder="little") if packed else shots
    kw = dict(bit_packed_shots=packed, bit_packed_predictions=packed)
    plain = dec.decode_batch(x.copy(), **kw)
    pred, got = dec.decode_batch(x.copy(), return_corrections=True, **kw)
    assert np.array_equal(pred, plain) and pred.dtype == plain.dtype
    if packed:
        assert got.dtype == np.uint8 and got.shape == (B, -(-dem.H.shape[1] // 8))
        got = np.unpackbits(got, axis=1, count=dem.H.shape[1], bitorder="little")
    assert got.dtype == np.uint8 and np.array_equal(got, corr)


@pytest.mark.parametrize("family", [T.BpOsdOverlappingWindowDecoder,
                                    T.LsdOverlappingWindowDecoder], ids=["bposd", "lsd"])
def test_default_return_is_the_predictions(family):
    dem, model, shots = _experiment()
    dec = _decoder(model, "device", family)
    corr = dec._corr_multiple_rounds_batch(shots.copy())
    want = (corr.astype(np.int64) @ dem.obs.T % 2).astype(bool)
    out = dec.decode_batch(shots.copy())
    assert isinstance(out, np.ndarray) and out.dtype == bool and np.array_equal(out, want)
    packed = dec.decode_batch(np.packbits(shots, axis=1, bitorder="little"),
                              bit_packed_shots=True, bit_packed_predictions=True)
    assert np.array_equal(packed, np.packbits(want, axis=1, bitorder="little"))


class _EchoDecoder:
    """A window decoder whose decoding of a column is its syndrome bit at
    the column's index modulo m: a function of the syndromes it is given,
    so a syndrome update that differs shows; where two windows both set a
    column, the host loop's ``+=`` leaves a 2."""

    def __init__(self, round_dcm):
        self.cols = np.arange(round_dcm.shape[1]) % round_dcm.shape[0]

    def decode_batch(self, syndromes):
        return np.asarray(syndromes, np.uint8)[:, self.cols]


class _ResidentEchoDecoder(_EchoDecoder):
    def _decode_batch_device(self, syndromes):
        return syndromes[:, torch.from_numpy(self.cols).to(syndromes.device)]


class _EchoOwd(T.BpOsdOverlappingWindowDecoder):
    window_decoder = _EchoDecoder

    def _init_decoder(self, round_dcm, weights):
        return self.window_decoder(round_dcm)


class _ResidentEchoOwd(_EchoOwd):
    window_decoder = _ResidentEchoDecoder


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_resident_arithmetic_equals_the_numpy_loop(packed):
    """The resident path's commits (``+=``), syndrome updates and
    predictions equal the numpy loop's on the same window decodings, every
    window through the loop, 2s included: unpacked corrections keep them,
    packing takes them as 1."""
    _, model, shots = _experiment()
    outs = []
    for cls in (_EchoOwd, _ResidentEchoOwd):
        dec = _decoder(model, "host", cls)
        x = np.packbits(shots, axis=1, bitorder="little") if packed else shots
        outs.append(_quiet(dec.decode_batch, x.copy(), bit_packed_shots=packed,
                           bit_packed_predictions=packed, return_corrections=True))
    (p_np, c_np), (p_dev, c_dev) = outs
    assert p_dev.dtype == p_np.dtype and np.array_equal(p_dev, p_np)
    assert c_dev.dtype == c_np.dtype and np.array_equal(c_dev, c_np)
    if not packed:
        assert (c_np == 2).any() and c_np.max() == 2
