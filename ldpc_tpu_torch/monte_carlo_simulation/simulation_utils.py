"""Simulation helpers, a copy of ``ldpc_tpu.monte_carlo_simulation.simulation_utils``
(reference:
src_python/ldpc/monte_carlo_simulation/simulation_utils.py).

Vectorized numpy implementations (the reference uses numba ``@njit``
scalar loops; on this stack plain vector numpy is faster and
dependency-free).
"""

from typing import Tuple

import numpy as np
from scipy.special import erfc, erfcinv

from ldpc_tpu_torch import mod2
from ldpc_tpu_torch.alist import alist2numpy  # noqa: F401  (parity re-export:
# the reference defines its own fixed copy at simulation_utils.py:29-49)


def set_seed(value: int) -> None:
    """Seed the global numpy RNG (reference: simulation_utils.py:21-26)."""
    np.random.seed(value)


def check_logical_err_h(
    check_matrix, original_err, decoded_estimate
) -> bool:
    """True iff the residual error is a *logical* (non-stabilizer)
    operator: residual not in rowspace(H)
    (reference: simulation_utils.py:52-76)."""
    residual = (np.asarray(original_err) + np.asarray(decoded_estimate)) % 2
    if not residual.any():
        return False
    htr = np.vstack(
        [np.asarray(_dense(check_matrix)), residual[None, :]]
    ).astype(np.uint8)
    return mod2.rank(htr) > mod2.rank(check_matrix)


def is_logical_err(L, residual_err) -> bool:
    """True iff any logical operator anticommutes with the residual
    (reference: simulation_utils.py:79-87)."""
    return bool(((_dense(L) @ np.asarray(residual_err)) % 2).any())


def generate_err(
    N: int, channel_probs, residual_err
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample an X/Z Pauli error pair on top of a residual error
    (reference: simulation_utils.py:90-127)."""
    px, py, pz = (np.asarray(c, dtype=float) for c in channel_probs)
    rand = np.random.random(N)
    z_hit = rand < pz
    x_hit = (~z_hit) & (rand < pz + px)
    y_hit = (~z_hit) & (~x_hit) & (rand < pz + px + py)
    # the reference aliases the residual: hits FLIP the residual bit,
    # non-hits KEEP it (simulation_utils.py:104-125)
    error_x = np.asarray(residual_err[0]).astype(np.int64).copy()
    error_z = np.asarray(residual_err[1]).astype(np.int64).copy()
    error_z[z_hit | y_hit] ^= 1
    error_x[x_hit | y_hit] ^= 1
    return error_x, error_z


def get_analog_llr(analog_syndrome: np.ndarray, sigma: float) -> np.ndarray:
    """LLR of an analog syndrome reading: 2y/sigma^2
    (reference: simulation_utils.py:130-133)."""
    return (2 * np.asarray(analog_syndrome)) / (sigma**2)


def get_sigma_from_syndr_er(ser: float) -> float:
    """Analog-cat syndrome noise conversion
    (reference: simulation_utils.py:135-143)."""
    return 1 / np.sqrt(2) / erfcinv(2 * ser)


def get_error_rate_from_sigma(sigma: float) -> float:
    """Inverse of :func:`get_sigma_from_syndr_er`
    (reference: simulation_utils.py:145-154)."""
    return 0.5 * erfc(1 / np.sqrt(2 * sigma**2))


def get_virtual_check_init_vals(noisy_syndr, sigma: float) -> np.ndarray:
    """Virtual (time-like) check channel values v_i = 1/(e^{|l_i|}+1)
    so BP initializes the analog nodes with the analog-info LLRs
    (reference: simulation_utils.py:156-163)."""
    llrs = get_analog_llr(noisy_syndr, sigma)
    with np.errstate(over="ignore"):
        return 1 / (np.exp(np.abs(llrs)) + 1)


def generate_syndr_err(channel_probs) -> np.ndarray:
    """Bernoulli syndrome-bit error sample
    (reference: simulation_utils.py:166-176)."""
    probs = np.asarray(channel_probs, dtype=float)
    return (np.random.random(probs.shape) < probs).astype(np.int32)


def get_noisy_analog_syndrome(
    perfect_syndr: np.ndarray, sigma: float
) -> np.ndarray:
    """Gaussian-smeared analog syndrome: signed syndrome + N(0, sigma)
    (reference: simulation_utils.py:179-193)."""
    signed = get_signed_from_binary(np.asarray(perfect_syndr))
    return np.random.normal(loc=signed, scale=sigma).astype(np.float64)


def error_channel_setup(error_rate, xyz_error_bias, N):
    """Per-Pauli channel from a scalar rate and bias triple
    (reference: simulation_utils.py:196-221)."""
    xyz_error_bias = np.asarray(xyz_error_bias, dtype=float)
    if np.isinf(xyz_error_bias[0]):
        px, py, pz = error_rate, 0.0, 0.0
    elif np.isinf(xyz_error_bias[1]):
        px, py, pz = 0.0, error_rate, 0.0
    elif np.isinf(xyz_error_bias[2]):
        px, py, pz = 0.0, 0.0, error_rate
    else:
        bias = xyz_error_bias / xyz_error_bias.sum()
        px, py, pz = error_rate * bias
    return (
        np.full(N, px),
        np.full(N, py),
        np.full(N, pz),
    )


def build_single_stage_pcm(H, M) -> np.ndarray:
    """Single-stage PCM [[H, I], [0, M]]
    (reference: simulation_utils.py:224-229)."""
    H = _dense(H)
    M = _dense(M)
    id_r = np.identity(H.shape[0], dtype=int)
    zeros = np.zeros((M.shape[0], H.shape[1]), dtype=int)
    return np.block([[H, id_r], [zeros, M]])


def get_signed_from_binary(binary_syndrome: np.ndarray) -> np.ndarray:
    """0/1 -> +1/-1 (reference: simulation_utils.py:231-237)."""
    return 1 - 2 * np.asarray(binary_syndrome)


def get_binary_from_analog(analog_syndrome: np.ndarray) -> np.ndarray:
    """Analog reading -> hard bit: negative = flipped
    (reference: simulation_utils.py:239-243)."""
    return (np.asarray(analog_syndrome) < 0).astype(np.int32)


def _dense(M) -> np.ndarray:
    return np.asarray(M.todense() if hasattr(M, "todense") else M)


def save_results(
    success_cnt: int,
    nr_runs: int,
    p: float,
    s: float,
    input_vals: dict,
    outfile: str,
    code_params,
    err_side: str = "X",
    bp_iterations: int = None,
    bp_params=None,
) -> dict:
    """Write one simulation result record as JSON
    (reference: simulation_utils.py:246-288): LER/WER with binomial error
    bars, run bookkeeping and the full input configuration; ``bias``
    infinities are JSON-encoded as "i"."""
    import json

    from ldpc_tpu_torch.monte_carlo_simulation.data_utils import (
        calculate_error_rates,
        replace_inf,
    )

    ler, ler_eb, wer, wer_eb = calculate_error_rates(
        success_cnt, nr_runs, code_params
    )
    output = {
        "code_K": code_params["k"],
        "code_N": code_params["n"],
        "nr_runs": nr_runs,
        "pers": p,
        "sers": s,
        f"{err_side}_ler": ler,
        f"{err_side}_ler_eb": ler_eb,
        f"{err_side}_wer": wer,
        f"{err_side}_wer_eb": wer_eb,
        f"{err_side}_success_cnt": success_cnt,
        "avg_bp_iterations": bp_iterations / nr_runs
        if bp_iterations is not None
        else None,
        "bp_params": bp_params,
    }
    output.update(input_vals)
    if "bias" in output:
        output["bias"] = replace_inf(output["bias"])
    with open(outfile, "w") as f:
        json.dump(
            output, f, ensure_ascii=False, indent=4,
            default=lambda o: o.__dict__,
        )
    return output
