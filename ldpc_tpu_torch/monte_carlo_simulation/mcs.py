"""Monte-Carlo BSC simulation, a copy of ``ldpc_tpu.monte_carlo_simulation.mcs``
(reference:
src_python/ldpc/monte_carlo_simulation/mcs.py).

Batch-first re-design: errors are sampled and decoded ``batch_size`` at
a time through ``decode_batch`` when the decoder provides it (every
decoder in this framework does), falling back to the reference's
one-at-a-time ``decode`` loop otherwise. Counters and the PRNG state
form a checkpointable dict (``checkpoint()``/``restore()``) so long
runs survive preemption — the fault-tolerance hook the reference leaves
as an unused ``save_interval`` parameter (mcs.py:84-86).
"""

import datetime
import time
from typing import Dict, Optional, Union

import numpy as np
import scipy.sparse as sp

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


class MonteCarloBscSimulation:
    """Syndrome-decoding Monte-Carlo simulation relative to the zero
    codeword (reference: mcs.py:10-159)."""

    def __init__(
        self,
        parity_check_matrix: Union[np.ndarray, sp.csr_matrix] = None,
        error_rate: float = None,
        Decoder=None,
        target_run_count: int = 1000,
        tqdm_disable: bool = False,
        save_interval: int = 60,
        seed: Optional[int] = None,
        run: bool = False,
        batch_size: int = 1024,
    ) -> None:
        if parity_check_matrix is None or not isinstance(
            parity_check_matrix, (np.ndarray, sp.csr_matrix, sp.spmatrix)
        ):
            raise ValueError(
                "parity_check_matrix should be of type np.ndarray or "
                f"scipy.sparse.csr_matrix. Not {type(parity_check_matrix)}"
            )
        self.parity_check_matrix = parity_check_matrix
        if (
            error_rate is None
            or not isinstance(error_rate, float)
            or not 0 <= error_rate <= 1
        ):
            raise ValueError(
                "Invalid error rate provided. The error rate should be a "
                "float with value between 0 and 1."
            )
        self.error_rate = error_rate
        if Decoder is None:
            raise ValueError("Invalid Decoder object provided.")
        self.Decoder = Decoder
        if not isinstance(target_run_count, int) or target_run_count <= 0:
            raise ValueError("Invalid target run count provided.")
        self.target_run_count = target_run_count
        if not isinstance(tqdm_disable, bool):
            raise ValueError("Invalid value for tqdm_disable flag.")
        self.tqdm_disable = tqdm_disable
        if not isinstance(save_interval, int) or save_interval <= 0:
            raise ValueError("Invalid save interval provided.")
        self.save_interval = save_interval
        if seed is not None and not isinstance(seed, int):
            raise ValueError(
                "Invalid seed provided. Please provide a postive integer"
            )
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.batch_size = batch_size

        self.run_count = 0
        self.fail_count = 0
        self.logical_error_rate = 0.0
        self.logical_error_rate_eb = 0.0
        if run:
            self.run()

    # ------------------------------------------------------------------
    def checkpoint(self) -> Dict:
        """Resumable state: tallies + PRNG state (deterministic resume)."""
        return {
            "run_count": self.run_count,
            "fail_count": self.fail_count,
            "rng_state": self._rng.bit_generator.state,
        }

    def restore(self, state: Dict) -> None:
        self.run_count = state["run_count"]
        self.fail_count = state["fail_count"]
        self._rng.bit_generator.state = state["rng_state"]

    # ------------------------------------------------------------------
    def _decode_block(self, errors: np.ndarray) -> int:
        """Decode a block of sampled errors; returns the failure count."""
        syndromes = (errors @ self.parity_check_matrix.T) % 2
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        if hasattr(self.Decoder, "decode_batch"):
            decodings = self.Decoder.decode_batch(syndromes)
            return int((decodings != errors).any(axis=1).sum())
        fails = 0
        for e, s in zip(errors, syndromes):
            if not np.array_equal(self.Decoder.decode(s), e):
                fails += 1
        return fails

    def run(self) -> Dict:
        self.start_date = datetime.datetime.fromtimestamp(
            time.time()
        ).strftime("%A, %B %d, %Y %H:%M:%S")
        n = self.parity_check_matrix.shape[1]
        remaining = self.target_run_count - self.run_count
        pbar = (
            tqdm(total=self.target_run_count, disable=self.tqdm_disable, ncols=0)
            if tqdm is not None
            else None
        )
        while remaining > 0:
            block = min(self.batch_size, remaining)
            errors = (
                self._rng.random((block, n)) < self.error_rate
            ).astype(np.uint8)
            self.fail_count += self._decode_block(errors)
            self.run_count += block
            remaining -= block
            self.logical_error_rate = self.fail_count / self.run_count
            self.logical_error_rate_eb = np.sqrt(
                self.logical_error_rate
                * (1 - self.logical_error_rate)
                / self.run_count
            )
            if pbar is not None:
                pbar.update(block)
                pbar.set_description(
                    f"Physical error rate: {100*self.error_rate:.2f}%; "
                    "Logical error rate: "
                    f"{100*self.logical_error_rate:.2f}+-"
                    f"{100*self.logical_error_rate_eb:.2f}%"
                )
        if pbar is not None:
            pbar.close()
        return self.save()

    def save(self) -> Dict:
        return {
            "logical_error_rate": self.logical_error_rate,
            "logical_error_rate_eb": self.logical_error_rate_eb,
            "error_rate": self.error_rate,
            "run_count": self.run_count,
            "fail_count": self.fail_count,
        }
