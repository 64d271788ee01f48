"""Faults of the ``window`` driver's timed path, each planted under a run
on the CPU: ``fault(monkeypatch)`` breaks the program before the driver is
built and returns a hook that breaks the built driver, or None.

One card and no state carried between calls; the nearest to a step that
hands its state on wrongly is the time-boundary bit one window hands the
next, which ``dropped_time_boundary`` drops."""

import torch


def flipped_correction(monkeypatch):
    """Bit 0 of every shot's total correction flipped."""

    def hook(driver):
        full = driver.decoder

        def flipped(syndromes, analog=None):
            r = full(syndromes, analog)
            x = r.correction.clone()
            x[:, 0] ^= 1
            return r._replace(correction=x)

        driver.decoder = flipped

    return hook


def iterations_off_by_one(monkeypatch):
    """Every shot's summed BP iterations one more than counted."""

    def hook(driver):
        full = driver.decoder

        def more(syndromes, analog=None):
            r = full(syndromes, analog)
            return r._replace(bp_iterations=r.bp_iterations + 1)

        driver.decoder = more

    return hook


def dropped_time_boundary(monkeypatch):
    """Each window's time-boundary bits dropped: the next window's first
    round takes no time-like correction."""
    from ldpc_tpu_torch.parallel import window

    plain = window._decode_window

    def dropped(*args, **kwargs):
        commit, tb, iters = plain(*args, **kwargs)
        return commit, torch.zeros_like(tb), iters

    monkeypatch.setattr(window, "_decode_window", dropped)


FAULTS = {"dropped_time_boundary": dropped_time_boundary,
          "flipped_correction": flipped_correction,
          "iterations_off_by_one": iterations_off_by_one}
