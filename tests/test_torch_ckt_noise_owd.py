"""The port's overlapping-window decoders end to end against the JAX
package's on the CPU (the DEM and its shots: tests/test_torch_ckt_noise.py):
the corrections of ``_corr_multiple_rounds_batch`` and the predictions of
``decode_batch`` (packed and unpacked), lane for lane, for both BP families
through the device windows and through the forced host loop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ldpc_tpu.ckt_noise as J
import ldpc_tpu_torch.ckt_noise as T
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
