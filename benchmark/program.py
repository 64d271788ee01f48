"""The system under test, built from a configuration: the only module of
the benchmark that imports ``ldpc_tpu_torch``."""

import numpy as np


def reference_params(cfg: dict) -> dict:
    """The decoder settings the plain reference takes."""
    d = cfg["decoder"]
    return {"error_rate": cfg["noise"]["error_rate"], "max_iter": d["max_iter"],
            "ms_scaling_factor": d["ms_scaling_factor"], "osd_method": d["osd_method"],
            "osd_order": d["osd_order"]}


def bposd_decoder(cfg: dict, hx: np.ndarray, device):
    import ldpc_tpu_torch

    d = cfg["decoder"]
    return ldpc_tpu_torch.BpOsdDecoder(
        hx, error_rate=float(cfg["noise"]["error_rate"]), max_iter=d["max_iter"],
        bp_method=d["bp_method"], ms_scaling_factor=d["ms_scaling_factor"],
        schedule=d["schedule"], osd_method=d["osd_method"], osd_order=d["osd_order"],
        dtype=d["dtype"], device=device)

