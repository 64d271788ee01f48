"""Faults of the ``batch`` driver's timed path, each planted under a run on
the CPU: ``fault(monkeypatch)`` breaks the program before the driver is
built and returns a hook that breaks the built driver, or None.

One card and no state, so no exchange between chips and no step that
returns its state unchanged."""

import numpy as np


def altered_answer(monkeypatch):
    """Bit 0 of every lane's decoding flipped where BP and OSD produce it."""
    from ldpc_tpu_torch.ops import bp_cuda, osd

    plain_bp, plain_osd = bp_cuda.bp_parallel, osd.make_osd_decoder

    def altered_bp(*args, **kwargs):
        r = plain_bp(*args, **kwargs)
        dec = r.decoding.clone()
        dec[:, 0] ^= 1
        return r._replace(decoding=dec)

    def altered_osd(*args, **kwargs):
        decode = plain_osd(*args, **kwargs)

        def flipped(syndromes, llrs):
            x0, xw, valid = decode(syndromes, llrs)
            x0, xw = x0.clone(), xw.clone()
            x0[:, 0] ^= 1
            xw[:, 0] ^= 1
            return x0, xw, valid

        return flipped

    monkeypatch.setattr(bp_cuda, "bp_parallel", altered_bp)
    monkeypatch.setattr(osd, "make_osd_decoder", altered_osd)


def half_batch(monkeypatch):
    """Half of each batch decoded, its decodings standing in for the rest."""

    def hook(driver):
        full = driver.decoder.decode_batch

        def half(syn):
            h = syn.shape[0] // 2
            out = full(syn[:h])
            return np.concatenate([out, out[: syn.shape[0] - h]])

        driver.decoder.decode_batch = half

    return hook


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch}
