"""The overlapping-window cell's entry: ``BpOsdOverlappingWindowDecoder``
of ``ldpc_tpu_torch.ckt_noise``, on a model with stim's instruction
interface."""


def bposd_owd(cfg: dict, model, device):
    from ldpc_tpu_torch.ckt_noise import BpOsdOverlappingWindowDecoder

    d = cfg["decoder"]
    keys = ("max_iter", "bp_method", "ms_scaling_factor", "osd_method", "osd_order", "dtype")
    return BpOsdOverlappingWindowDecoder(
        model, decodings=cfg["decodings"], window=cfg["window"], commit=cfg["commit"],
        num_checks=model.num_checks, device=device,
        decoder_config={k: d[k] for k in keys})
