"""The port's overlapping-window decoders end to end against the JAX
package's on the CPU (the DEM and its shots: tests/test_torch_ckt_noise.py):
the corrections of ``_corr_multiple_rounds_batch`` and the predictions of
``decode_batch`` (packed and unpacked), lane for lane, for both BP families
through the device windows and through the forced host loop; the resident
call's returned corrections and its counters; and a window decoder without
the device entry, which keeps the numpy loop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ldpc_tpu.ckt_noise as J
import ldpc_tpu_torch.ckt_noise as T
from ldpc_tpu_torch.utils import profiling as pf
from test_torch_ckt_noise import _surface_shots

torch.set_num_threads(1)


FAMILIES = {
    "bposd": (J.BpOsdOverlappingWindowDecoder, T.BpOsdOverlappingWindowDecoder),
    "lsd": (J.LsdOverlappingWindowDecoder, T.LsdOverlappingWindowDecoder),
}
_JAX_CORRECTIONS = {}


def _jax_corrections(family, shots, kwargs, dem):
    """The JAX package's corrections of ``_surface_shots()``, through its
    scan and through its host loop: one decoder, so the boundary windows'
    programs compile once for both."""
    if family not in _JAX_CORRECTIONS:
        j = FAMILIES[family][0](dem, **kwargs)
        assert j._maybe_device_scan() is not None
        scan = j._corr_multiple_rounds_batch(shots.copy())
        j._device_scan = None  # the pure host loop, as tests/test_ckt_noise.py forces it
        _JAX_CORRECTIONS[family] = {"device": scan,
                                    "host": j._corr_multiple_rounds_batch(shots.copy())}
    return _JAX_CORRECTIONS[family]


@pytest.mark.parametrize("path", ["device", "host"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_owd_matches_jax(family, path):
    """Corrections and predictions on every lane: the device windows (the
    JAX package's scan) or the forced host loop on both sides. The JAX
    package's predictions are ``decode_batch``'s: its corrections through
    the observables matrix, mod 2."""
    dem, kwargs, shots, errs, mats = _surface_shots()
    t = FAMILIES[family][1](dem, device="cpu", **kwargs)
    if path == "host":
        t._device_scan = None
    else:
        uw = t._maybe_device_scan()[0]
        assert (uw.w_lo, uw.w_hi) == (1, 4)
    cj = _jax_corrections(family, shots, kwargs, dem)[path]
    ct = t._corr_multiple_rounds_batch(shots.copy())
    assert ct.dtype == cj.dtype == np.uint8
    assert np.flatnonzero((cj != ct).any(axis=1)).tolist() == []
    obs = np.asarray(mats.observables_matrix.todense())
    want = ((cj @ obs.T) % 2).astype(bool)
    pt = t.decode_batch(shots.copy())
    assert pt.dtype == bool and np.array_equal(pt, want)
    # the decoder decodes: most shots predict their own observable flip
    truth = (errs @ obs.T % 2).astype(bool)
    assert (pt == truth).all(axis=1).mean() > 0.95
    # packed shots in, packed predictions out, as sinter feeds them
    packed = np.packbits(shots, axis=1, bitorder="little")
    out = t.decode_batch(packed, bit_packed_shots=True, bit_packed_predictions=True)
    assert np.array_equal(out, np.packbits(want, axis=1, bitorder="little"))


def _port(family, path, dem, kwargs, cls=None):
    t = (cls or FAMILIES[family][1])(dem, device="cpu", **kwargs)
    if path == "host":
        t._device_scan = None
    return t


def _recorded(fn, *args, **kwargs):
    """``fn``'s result and the counters it recorded."""
    pf.drain()
    pf.record(True)
    try:
        out = fn(*args, **kwargs)
    finally:
        pf.record(False)
    return out, pf.drain().counters


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("path", ["device", "host"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_resident_call_returns_jax_corrections(family, path, packed):
    """A call on the resident state returns the JAX package's corrections,
    values and dtype, or ``np.packbits`` of them, and their predictions;
    every window decodes on the resident state, and only the returned
    arrays cross back to the host."""
    dem, kwargs, shots, _, mats = _surface_shots()
    t = _port(family, path, dem, kwargs)
    cj = _jax_corrections(family, shots, kwargs, dem)[path]
    want = (cj @ np.asarray(mats.observables_matrix.todense()).T % 2).astype(bool)
    x = np.packbits(shots, axis=1, bitorder="little") if packed else shots
    (pred, corr), counters = _recorded(
        t.decode_batch, x.copy(), bit_packed_shots=packed, bit_packed_predictions=packed,
        return_corrections=True)
    if packed:
        cj, want = (np.packbits(a, axis=1, bitorder="little") for a in (cj, want))
    assert corr.dtype == cj.dtype and np.array_equal(corr, cj)
    assert pred.dtype == want.dtype and np.array_equal(pred, want)
    assert counters["owd.windows.resident"] == kwargs["decodings"]
    assert counters["owd.d2h_bytes"] == pred.nbytes + corr.nbytes


class _NumpyOnly:
    """A window decoder that offers only a numpy ``decode_batch``."""

    def __init__(self, decoder):
        self._decoder = decoder

    def decode_batch(self, syndromes):
        return self._decoder.decode_batch(syndromes)


class _NumpyOnlyOwd(T.BpOsdOverlappingWindowDecoder):
    def _init_decoder(self, round_dcm, weights):
        return _NumpyOnly(super()._init_decoder(round_dcm, weights))


def test_window_decoder_without_device_entry_keeps_numpy_loop():
    """Window decoders without ``_decode_batch_device`` keep the numpy
    loop over every window: the same corrections as the JAX package's host
    loop and no window on the resident state."""
    dem, kwargs, shots, _, _ = _surface_shots()
    t = _port("bposd", "device", dem, kwargs, _NumpyOnlyOwd)
    ct, counters = _recorded(t._corr_multiple_rounds_batch, shots.copy())
    cj = _jax_corrections("bposd", shots, kwargs, dem)["host"]
    assert ct.dtype == cj.dtype and np.array_equal(ct, cj)
    assert counters.get("owd.windows.resident", 0) == 0 and "owd.d2h_bytes" not in counters
    assert counters["owd.windows.host"] == kwargs["decodings"]
    assert "owd.windows.device" not in counters
