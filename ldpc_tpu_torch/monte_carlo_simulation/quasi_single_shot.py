"""Quasi-single-shot phenomenological simulation, the port of
``ldpc_tpu.monte_carlo_simulation.quasi_single_shot``
(reference: src_python/ldpc/monte_carlo_simulation/quasi_single_shot_v2.py,
after the analog-information-decoding work of Timo/Lucas).

A data+syndrome-noise memory experiment decoded with sliding windows
over the multiround PCM. Differences from the reference: no hardcoded
result paths (the reference reads a personal filesystem path at
quasi_single_shot_v2.py:92-96); results return as a dict and
``code_params`` is an explicit argument. The window decoder is the port's
``BpOsdDecoder`` or ``BpLsdDecoder`` on ``device`` (the CUDA device unless
the caller passes ``device="cpu"``).
"""

from typing import Dict, List, Optional

import numpy as np

from ldpc_tpu_torch.monte_carlo_simulation.data_utils import (
    BpParams,
    _check_convergence,
    calculate_error_rates,
)
from ldpc_tpu_torch.monte_carlo_simulation.memory_experiment import (
    build_multiround_pcm,
    decode_multiround,
    move_syndrome,
)
from ldpc_tpu_torch.monte_carlo_simulation.simulation_utils import (
    error_channel_setup,
    generate_err,
    generate_syndr_err,
    get_binary_from_analog,
    get_noisy_analog_syndrome,
    get_sigma_from_syndr_er,
    is_logical_err,
    set_seed,
)


class QssSimulator:
    """Quasi-single-shot simulator (reference:
    quasi_single_shot_v2.py:28-327)."""

    def __init__(
        self,
        H: np.ndarray,
        per: float,
        ser: float,
        L: np.ndarray,
        bias: List[float],
        codename: str = "",
        bp_params: Optional[BpParams] = None,
        decoding_method: str = "bposd",
        check_side: str = "X",
        seed: int = 666,
        analog_tg: bool = False,
        repetitions: int = 0,
        rounds: int = 0,
        code_params: Optional[Dict] = None,
        device="cuda",
        **kwargs,
    ) -> None:
        self.H = np.asarray(H)
        self.data_err_rate = per
        self.syndr_err_rate = ser
        self.check_side = check_side
        self.L = np.asarray(L)
        self.bias = bias
        self.codename = codename
        self.bp_params = bp_params or BpParams()
        self.decoding_method = decoding_method
        self.save_interval = kwargs.get("save_interval", 50)
        self.eb_precission = kwargs.get("eb_precission", 1e-2)
        self.analog_tg = analog_tg
        self.repetitions = repetitions
        if repetitions % 2 != 0:
            raise ValueError("repetitions must be even")
        if decoding_method not in ("bposd", "matching", "lsd"):
            raise ValueError("Decoding method must be either bposd or matching")
        self.rounds = rounds
        self.code_params = code_params or {
            "n": self.H.shape[1],
            "k": max(self.L.shape[0], 1),
        }
        set_seed(seed)

        self.num_checks, self.num_qubits = self.H.shape
        self.x_bit_chnl, self.y_bit_chnl, self.z_bit_chnl = error_channel_setup(
            error_rate=per, xyz_error_bias=bias, N=self.num_qubits
        )
        xs, ys, zs = error_channel_setup(
            error_rate=ser, xyz_error_bias=bias, N=self.num_checks
        )
        if check_side == "X":
            self.err_idx = 1  # Z data errors flip X checks
            self.data_err_channel = self.y_bit_chnl + self.z_bit_chnl
            self.syndr_err_channel = zs + ys
        else:
            self.err_idx = 0
            self.data_err_channel = self.x_bit_chnl + self.y_bit_chnl
            self.syndr_err_channel = xs + ys

        self.H3D = build_multiround_pcm(self.H, self.repetitions - 1)
        self.check_block_size = self.num_qubits * self.repetitions
        channel_probs = np.zeros(self.H3D.shape[1])
        channel_probs[: self.check_block_size] = np.tile(
            self.data_err_channel, self.repetitions
        )
        channel_probs[self.check_block_size:] = np.tile(
            self.syndr_err_channel, self.repetitions
        )
        self.sigma = (
            get_sigma_from_syndr_er(self.syndr_err_channel[0])
            if analog_tg
            else None
        )
        self.bp_iterations = 0.0
        if decoding_method == "bposd":
            from ldpc_tpu_torch.decoders.bposd_decoder import BpOsdDecoder

            self.decoder = BpOsdDecoder(
                self.H3D.tocsr(),
                error_channel=channel_probs.tolist(),
                max_iter=self.bp_params.max_bp_iter,
                bp_method="minimum_sum",
                osd_order=self.bp_params.osd_order,
                osd_method=self.bp_params.osd_method,
                ms_scaling_factor=self.bp_params.ms_scaling_factor,
                device=device,
            )
        elif decoding_method == "lsd":
            from ldpc_tpu_torch.decoders.bplsd_decoder import BpLsdDecoder

            self.decoder = BpLsdDecoder(
                self.H3D.tocsr(),
                error_channel=list(channel_probs),
                max_iter=self.bp_params.max_bp_iter,
                bp_method="ms",
                ms_scaling_factor=self.bp_params.ms_scaling_factor,
                lsd_order=0,
                device=device,
            )
        else:  # matching
            from pymatching import Matching  # optional dependency

            with np.errstate(divide="ignore"):
                weights = np.log((1 - channel_probs) / channel_probs)
            self.decoder = Matching(self.H3D, weights=weights)
        self.channel_probs = channel_probs

    # ------------------------------------------------------------------
    def _decode_multiround(self, syndrome_mat, analog_syndr_mat, last_round):
        return decode_multiround(
            syndrome=syndrome_mat,
            H=self.H,
            decoder=self.decoder,
            repetitions=self.repetitions,
            last_round=last_round,
            analog_syndr=analog_syndr_mat,
            check_block_size=self.check_block_size,
            sigma=self.sigma,
            H3D=self.H3D if self.decoding_method == "matching" else None,
            channel_probs=self.channel_probs,
            decoding_method=self.decoding_method,
        )

    def _single_sample(self) -> int:
        """(reference: quasi_single_shot_v2.py:210-298)"""
        syndrome_mat = np.zeros(
            (self.num_checks, self.repetitions), dtype=np.int32
        )
        analog_syndr_mat = (
            np.zeros((self.num_checks, self.repetitions), dtype=np.float64)
            if self.analog_tg
            else None
        )
        err = np.zeros(self.num_qubits, dtype=np.int32)
        cnt = 0
        analog_syndrome = None
        for rnd in range(self.rounds):
            residual_err = [np.copy(err), np.copy(err)]
            err = generate_err(
                N=self.num_qubits,
                channel_probs=[
                    self.x_bit_chnl,
                    self.y_bit_chnl,
                    self.z_bit_chnl,
                ],
                residual_err=residual_err,
            )[self.err_idx]
            noiseless_syndrome = (self.H @ err) % 2
            if rnd != self.rounds - 1:
                if self.analog_tg:
                    analog_syndrome = get_noisy_analog_syndrome(
                        noiseless_syndrome, self.sigma
                    )
                    syndrome = get_binary_from_analog(analog_syndrome)
                else:
                    syndrome_error = generate_syndr_err(self.syndr_err_channel)
                    syndrome = (noiseless_syndrome + syndrome_error) % 2
            else:  # last round is perfect
                syndrome = np.copy(noiseless_syndrome)
                analog_syndrome = get_noisy_analog_syndrome(
                    noiseless_syndrome, 0.0
                )
            syndrome_mat[:, cnt] += syndrome
            if self.analog_tg:
                analog_syndr_mat[:, cnt] += analog_syndrome
            cnt += 1
            if cnt == self.repetitions:
                last = rnd == self.rounds - 1
                corr, syndrome_mat, analog_syndr_mat, bp_iters = (
                    self._decode_multiround(
                        syndrome_mat, analog_syndr_mat, last_round=last
                    )
                )
                self.bp_iterations += bp_iters / self.rounds
                err = (err + corr) % 2
                if not last:
                    cnt = self.repetitions // 2
                    syndrome_mat = move_syndrome(syndrome_mat)
                    if self.analog_tg:
                        analog_syndr_mat = move_syndrome(
                            analog_syndr_mat, data_type=np.float64
                        )
        return int(not is_logical_err(self.L, err))

    def _results(self, success_cnt: int, samples: int) -> Dict:
        ler, ler_eb, wer, wer_eb = calculate_error_rates(
            success_cnt, samples, self.code_params
        )
        side = "z" if self.check_side == "X" else "x"
        return {
            f"{side}_ler": ler,
            f"{side}_ler_eb": ler_eb,
            f"{side}_wer": wer,
            f"{side}_wer_eb": wer_eb,
            f"{side}_success_cnt": success_cnt,
            "nr_runs": samples,
            "p": self.data_err_rate,
            "s": self.syndr_err_rate,
            "bp_iterations": self.bp_iterations,
        }

    def run(self, samples: int = 1) -> Dict:
        success_cnt = 0
        run = 0
        for run in range(1, samples + 1):
            success_cnt += self._single_sample()
            if run % self.save_interval == 1 and _check_convergence(
                success_cnt, run, self.code_params, self.eb_precission
            ):
                break
        return self._results(success_cnt, run)


# reference-compatible alias
QSS_SimulatorV2 = QssSimulator
