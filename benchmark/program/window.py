"""The sliding-window cell's entry: ``make_window_decoder`` of
``ldpc_tpu_torch.parallel``, on the code's checks handed in from
outside."""


def window_decoder(cfg: dict, hx, sigma, device):
    """The configuration's window decoder; analog mode where ``sigma`` is
    given. Call it as ``decode(syndromes, analog)``."""
    from ldpc_tpu_torch.parallel import make_window_decoder

    d, noise = cfg["decoder"], cfg["noise"]
    return make_window_decoder(
        hx, cfg["window"], noise["p"], noise["q"], sigma=sigma, max_iter=d["max_iter"],
        bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"], osd=True,
        postprocess=d["postprocess"], last_round_rate=d["last_round_rate"], device=device)


def decode_to_host(decoder, syndromes, analog):
    """One call as the cell's caller makes it: ``decoder(syndromes,
    analog)``, then its corrections and summed iterations copied to numpy,
    ``(corrections, iterations)``. The decoder returns its results on the
    device without waiting for them, so the call is wrapped in the
    recorder's span ``window.call``: the call's root then ends after the
    copies that end the call, as the other cells' roots do."""
    from ldpc_tpu_torch.utils.profiling import span

    with span("window.call", lanes=len(syndromes)):
        r = decoder(syndromes, analog)
        return r.correction.cpu().numpy(), r.bp_iterations.cpu().numpy()
