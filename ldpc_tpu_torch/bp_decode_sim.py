"""ldpc-v1 ``bp_decode_sim`` compatibility shim (port of
``ldpc_tpu.bp_decode_sim``).

The reference's own ``examples/classical_bp_decode_sim.py`` imports
``ldpc.bp_decode_sim.classical_decode_sim`` — an LDPCv1-era API that the
v2 package no longer ships. Provided here as a thin wrapper over the
batched Monte-Carlo harness (:class:`MonteCarloBscSimulation` driving
:class:`BpDecoder`'s ``decode_batch``) so v1-era scripts run unchanged.
"""

import datetime
import json
from typing import Optional


def classical_decode_sim(
    pcm,
    error_rate: float,
    target_runs: int = 1000,
    max_iter: int = 0,
    seed: Optional[int] = None,
    bp_method: str = "ms",
    ms_scaling_factor: float = 1.0,
    schedule: str = "parallel",
    output_file: Optional[str] = None,
    output_dict: Optional[dict] = None,
    device="cuda",
):
    """BSC Monte-Carlo word-error simulation of BP decoding (LDPCv1's
    ``bp_decode_sim.classical_decode_sim``) on ``device``. Returns (and
    optionally JSON-dumps) a result dict with the v1 fields."""
    from ldpc_tpu_torch.decoders.bp_decoder import BpDecoder
    from ldpc_tpu_torch.monte_carlo_simulation import MonteCarloBscSimulation

    output_dict = dict(output_dict or {})
    decoder = BpDecoder(
        pcm,
        error_rate=float(error_rate),
        max_iter=max_iter,
        bp_method=bp_method,
        ms_scaling_factor=ms_scaling_factor,
        schedule=schedule,
        device=device,
    )
    sim = MonteCarloBscSimulation(
        pcm,
        error_rate=float(error_rate),
        Decoder=decoder,
        target_run_count=target_runs,
        seed=seed,
        tqdm_disable=True,
    )
    res = sim.run()
    output_dict.update(
        {
            "error_rate": float(error_rate),
            "target_runs": target_runs,
            "run_count": res["run_count"],
            "fail_count": res["fail_count"],
            "word_error_rate": res["logical_error_rate"],
            "word_error_rate_eb": res.get("logical_error_rate_eb"),
            "max_iter": max_iter,
            "bp_method": bp_method,
            "ms_scaling_factor": ms_scaling_factor,
            "seed": seed,
            "date": datetime.datetime.now().isoformat(),
        }
    )
    if output_file:
        with open(output_file, "w") as f:
            json.dump(output_dict, f, indent=2, default=str)
    return output_dict
