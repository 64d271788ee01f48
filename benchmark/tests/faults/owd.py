"""Faults of the ``owd`` driver's timed path, each planted under a run on
the CPU: ``fault(monkeypatch)`` breaks the program before the driver is
built and returns a hook that breaks the built driver, or None.

One card and no state carried between calls, so no exchange between chips
and no step that returns its state unchanged; the running correction that
the device windows carry is the nearest, and ``skipped_device_windows``
hands it back untouched."""

import numpy as np


def altered_answer(monkeypatch):
    """Bit 0 of every lane's window decoding flipped where BP produces it."""
    from ldpc_tpu_torch.ops import bp_cuda

    plain = bp_cuda.bp_parallel

    def altered(*args, **kwargs):
        r = plain(*args, **kwargs)
        dec = r.decoding.clone()
        dec[:, 0] ^= 1
        return r._replace(decoding=dec)

    monkeypatch.setattr(bp_cuda, "bp_parallel", altered)


def skipped_device_windows(monkeypatch):
    """The device windows return the running correction they were given."""
    from ldpc_tpu_torch.ckt_noise import device_scan

    plain = device_scan.make_device_owd

    def skipping(*args, **kwargs):
        plain(*args, **kwargs)
        return lambda shots, total_in: total_in

    monkeypatch.setattr(device_scan, "make_device_owd", skipping)


def half_batch(monkeypatch):
    """Half of each batch decoded, its corrections standing in for the rest."""

    def hook(driver):
        full = driver.decoder.decode_batch

        def half(shots, **kwargs):
            h = shots.shape[0] // 2
            pred, corr = full(shots[:h], **kwargs)
            rest = shots.shape[0] - h
            return np.concatenate([pred, pred[:rest]]), np.concatenate([corr, corr[:rest]])

        driver.decoder.decode_batch = half

    return hook


def flipped_predictions(monkeypatch):
    """Every shot's packed prediction of observable 0 flipped, its
    correction left as decoded."""

    def hook(driver):
        full = driver.decoder.decode_batch

        def flipped(shots, **kwargs):
            pred, corr = full(shots, **kwargs)
            pred = pred.copy()
            pred[:, 0] ^= 1
            return pred, corr

        driver.decoder.decode_batch = flipped

    return hook


FAULTS = {"altered_answer": altered_answer, "flipped_predictions": flipped_predictions,
          "half_batch": half_batch, "skipped_device_windows": skipped_device_windows}
