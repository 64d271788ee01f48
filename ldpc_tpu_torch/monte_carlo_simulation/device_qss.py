"""Device-resident quasi-single-shot (QSS) simulation.

Port of ``ldpc_tpu.monte_carlo_simulation.device_qss`` (single device).
The reference QSS simulator decodes one shot at a time on the host:
per round it samples a Pauli error on top of the residual, extracts a
noisy syndrome, and every ``repetitions//2`` rounds runs a sliding window
of the space-time PCM through BP+OSD, feeding the committed correction
back into the running error (reference:
src_python/ldpc/monte_carlo_simulation/quasi_single_shot_v2.py:210-298).

Here a call simulates a batch of complete multi-round shots on the
device:

    uniform / normal draws -> per-round Pauli hits on the residual
         -> syndrome extraction (f32 matmul) + measurement noise (binary
            or analog-Gaussian)
         -> sliding-window decode on the space-time PCM (BP, K1', with
            OSD-0, K2', on the lanes BP leaves unconverged), the window
            engine of :mod:`ldpc_tpu_torch.parallel.window`
         -> committed-correction feedback (err ^= commit, tentative-region
            syndrome propagation, time-boundary bit carry)
         -> final logical check -> counters

Drawing is apart from decoding (:meth:`QssStep.draw`, :meth:`QssStep.run`),
so given draws can be fed through the decoding. A call draws from an
explicit ``torch.Generator``; :class:`DeviceQss` seeds call ``i`` from
``(seed, i)`` so that a checkpointed run resumes exactly.
"""

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.monte_carlo_simulation.device_mc import call_seed
from ldpc_tpu_torch.monte_carlo_simulation.simulation_utils import (
    error_channel_setup,
    get_sigma_from_syndr_er,
)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class QssShots(NamedTuple):
    """Per-shot outcome of one QSS call."""

    residual: torch.Tensor  # (B, n) uint8, the error left after every commit
    logical_fail: torch.Tensor  # (B,) bool, a logical anticommutes with it
    bp_iterations: torch.Tensor  # (B,) int32, summed over the windows


class QssStep:
    """One QSS call: ``step(generator) -> (4,) int64 counters``
    ``[runs, logical_fails, bp_iters_total, windows_decoded]``.

    ``draw(generator)`` makes a call's random numbers, ``run(u, noise)``
    simulates and decodes the shots on them: ``u`` (R, B, n) float32
    uniforms, one per qubit and round, ``noise`` (R, B, m) float32, the
    measurement noise of each check and round (uniforms in binary mode,
    standard normals with ``analog_tg``).
    """

    def __init__(
        self,
        pcm,
        per: float,
        ser: float,
        logicals,
        *,
        repetitions: int,
        rounds: int,
        xyz_error_bias: Sequence[float],
        check_side: str,
        analog_tg: bool,
        batch_size: int,
        max_iter: int,
        bp_method: str,
        ms_scaling_factor: float,
        osd: bool,
        device,
    ):
        if repetitions % 2 != 0:
            raise ValueError("repetitions must be even")
        W = int(repetitions)
        T = W // 2
        R = int(rounds)
        if R < W or R % T:
            raise ValueError(
                f"rounds={R} must be a multiple of {T} and >= repetitions={W} "
                "so every window fills completely"
            )
        self.W, self.T, self.R = W, T, R
        self.NW = R // T - 1  # number of window decodes
        pcm = convert_to_binary_sparse(pcm)
        m, n = pcm.shape
        self.m, self.n = m, n
        self.batch = _round_up(int(batch_size), 8)
        self.analog_tg = analog_tg

        # channels exactly as QssSimulator.__init__ (quasi_single_shot_v2.py)
        xb, yb, zb = error_channel_setup(per, xyz_error_bias, n)
        xs, ys, zs = error_channel_setup(ser, xyz_error_bias, m)
        if check_side == "X":
            self.err_idx = 1  # Z data errors flip X checks
            data_channel = yb + zb
            syndr_channel = zs + ys
        elif check_side == "Z":
            self.err_idx = 0
            data_channel = xb + yb
            syndr_channel = xs + ys
        else:
            raise ValueError("check_side must be 'X' or 'Z'")

        # deferred: ldpc_tpu_torch.parallel.window imports from this package
        from ldpc_tpu_torch.parallel.window import _build_core

        self.device = resolve_device(device)
        sigma = get_sigma_from_syndr_er(syndr_channel[0]) if analog_tg else None
        self.core = _build_core(
            pcm,
            W,
            data_channel,
            syndr_channel,
            max_iter=max_iter,
            bp_method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            osd=osd,
            sigma=sigma,
            device=self.device,
        )

        def f32(x) -> torch.Tensor:
            return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

        self.Ht = f32(np.asarray(pcm.todense(), np.float32).T)
        self.Lt = f32(np.asarray(convert_to_binary_sparse(logicals).todense(), np.float32).T)
        # threshold layout of one uniform draw per qubit (reference
        # simulation_utils.py:104-125): [0,pz) -> Z, [pz,pz+px) -> X,
        # [pz+px,pz+px+py) -> Y. The tracked component flips on Z|Y hits
        # (err_idx=1) or X|Y hits (err_idx=0).
        self.t0 = f32(zb)
        self.t1 = f32(zb + xb)
        self.t2 = f32(zb + xb + yb)
        self.p_syn = f32(syndr_channel)
        self.sigma = f32(0.0 if sigma is None else sigma)

    def draw(self, generator: torch.Generator):
        """``(u, noise)`` of one call, drawn from ``generator``."""
        shape = (self.R, self.batch)
        u = torch.rand((*shape, self.n), generator=generator, device=self.device)
        sample = torch.randn if self.analog_tg else torch.rand
        noise = sample((*shape, self.m), generator=generator, device=self.device)
        return u, noise

    def run(self, u: torch.Tensor, noise: torch.Tensor) -> QssShots:
        """Simulate and decode the shots of the draws ``(u, noise)``."""
        from ldpc_tpu_torch.parallel.window import _decode_window, mod2_matmul

        core, dev = self.core, self.device
        u = torch.as_tensor(u, dtype=torch.float32, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        B, m, n, W, T, R = u.shape[1], self.m, self.n, self.W, self.T, self.R
        if u.shape != (R, B, n) or noise.shape != (R, B, m):
            raise ValueError(
                f"draws must have shapes ({R}, B, {n}) and ({R}, B, {m}), not "
                f"{tuple(u.shape)} and {tuple(noise.shape)}"
            )
        err = torch.zeros((B, n), dtype=torch.uint8, device=dev)
        buf = torch.zeros((B, m, W), dtype=torch.uint8, device=dev)
        abuf = torch.zeros((B, m, W), dtype=torch.float32, device=dev) if self.analog_tg else None
        iters = torch.zeros(B, dtype=torch.int32, device=dev)

        def fill(err, r0, col0):
            """Measure T rounds from global round r0 into buffer columns
            col0.. : flip the residual, then measure noisily."""
            for t in range(T):
                r = r0 + t
                final = r == R - 1
                if self.err_idx == 1:
                    hit = (u[r] < self.t0) | ((u[r] >= self.t1) & (u[r] < self.t2))
                else:
                    hit = (u[r] >= self.t0) & (u[r] < self.t2)
                err = err ^ hit.to(torch.uint8)
                s = mod2_matmul(err, self.Ht)
                if abuf is not None:
                    signed = 1.0 - 2.0 * s.to(torch.float32)
                    analog = signed + (0.0 if final else self.sigma) * noise[r]
                    abuf[:, :, col0 + t] = analog
                    s = (analog < 0).to(torch.uint8)
                elif not final:
                    s = s ^ (noise[r] < self.p_syn).to(torch.uint8)
                buf[:, :, col0 + t] = s
            return err

        err = fill(err, 0, 0)
        for w in range(self.NW):
            err = fill(err, (w + 1) * T, T)
            commit, tc, bp_iters = _decode_window(core, buf, w == self.NW - 1, abuf)
            iters = iters + bp_iters
            err = err ^ commit  # feedback: the decoder corrects the device
            # slide the window: tentative half ^ committed-correction
            # syndrome; its first column also absorbs the time-boundary bit
            # (decode_multiround, memory_experiment_v2.py:134-144)
            shifted = buf[:, :, T:] ^ mod2_matmul(commit, self.Ht)[:, :, None]
            shifted[:, :, 0] ^= tc
            buf = torch.cat([shifted, torch.zeros_like(shifted)], dim=2)
            if abuf is not None:
                abuf = torch.cat([abuf[:, :, T:], torch.zeros_like(abuf[:, :, T:])], dim=2)
        fail = (mod2_matmul(err, self.Lt) > 0).any(dim=1)
        return QssShots(residual=err, logical_fail=fail, bp_iterations=iters)

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        shots = self.run(*self.draw(generator))
        B = shots.logical_fail.shape[0]
        return torch.stack(
            [
                torch.tensor(B, device=self.device),
                shots.logical_fail.sum(),
                shots.bp_iterations.to(torch.int64).sum(),
                torch.tensor(B * self.NW, device=self.device),
            ]
        ).to(torch.int64)


def make_qss_step(
    pcm,
    per: float,
    ser: float,
    logicals,
    *,
    repetitions: int,
    rounds: int,
    xyz_error_bias: Sequence[float] = (1.0, 1.0, 1.0),
    check_side: str = "X",
    analog_tg: bool = False,
    batch_size: int = 1024,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    osd: bool = True,
    device="cuda",
):
    """Build a batched QSS step ``fn(generator) -> counters`` on ``device``.

    Per call: ``batch_size`` (rounded up to a multiple of 8) complete shots
    of ``rounds`` noisy measurement rounds each, decoded with sliding
    windows of ``repetitions`` rounds (committing half a window at a time,
    final round perfect). Counters (int64): ``[runs, logical_fails,
    bp_iters_total, windows_decoded]``. Returns ``(step, runs_per_call)``;
    ``step`` is a :class:`QssStep`.

    Semantics match ``QssSimulator._single_sample`` (reference
    quasi_single_shot_v2.py:210-298) with a batched device RNG instead of
    the host's sequential numpy stream: per round one uniform per qubit
    selects Z/X/Y hits that flip the tracked residual component (reference
    simulation_utils.py:90-127); binary measurement noise is
    Bernoulli(``ser``-channel) per check, or with ``analog_tg`` a
    Gaussian-smeared signed syndrome whose sign gives the hard bit and whose
    magnitude re-initialises the time-like BP priors
    (simulation_utils.py:156-163).
    """
    step = QssStep(
        pcm,
        per,
        ser,
        logicals,
        repetitions=repetitions,
        rounds=rounds,
        xyz_error_bias=xyz_error_bias,
        check_side=check_side,
        analog_tg=analog_tg,
        batch_size=batch_size,
        max_iter=max_iter,
        bp_method=bp_method,
        ms_scaling_factor=ms_scaling_factor,
        osd=osd,
        device=device,
    )
    return step, step.batch


def make_sharded_qss_step(
    pcm,
    per: float,
    ser: float,
    logicals,
    *,
    mesh=None,
    batch_size_per_device: int = 1024,
    **kwargs,
):
    """Multi-device QSS: data-parallel over the mesh's ``batch`` axis
    (every visible card by default). Every entry simulates its own shots
    (:class:`QssStep`) on its own generator and the counters are summed
    (:class:`~ldpc_tpu_torch.monte_carlo_simulation.device_mc.ShardedStep`).
    Returns ``(step, runs_per_call)``; ``kwargs`` are
    :func:`make_qss_step`'s."""
    from ldpc_tpu_torch.monte_carlo_simulation.device_mc import make_sharded_step

    def make_local(**kw):
        return make_qss_step(pcm, per, ser, logicals, **kw)

    return make_sharded_step(make_local, mesh, batch_size_per_device, kwargs)


class DeviceQss:
    """Device-resident QSS logical-error-rate estimator.

    Batched drop-in for :class:`QssSimulator.run` on large sample counts:
    same channel setup, window schedule and feedback semantics, thousands
    of shots per call. ``checkpoint()`` / ``restore()`` serialise the
    counters and the call index for an exact resume, like
    :class:`DeviceMonteCarlo`.
    """

    def __init__(
        self,
        H,
        per: float,
        ser: float,
        L,
        *,
        seed: int = 0,
        code_params: Optional[Dict] = None,
        check_side: str = "X",
        device="cuda",
        **kwargs,
    ):
        self.device = resolve_device(device)
        self._step, self.runs_per_call = make_qss_step(
            H, per, ser, L, check_side=check_side, device=self.device, **kwargs
        )
        self.check_side = check_side
        self.per = per
        self.ser = ser
        L = convert_to_binary_sparse(L)
        self.code_params = code_params or {
            "n": convert_to_binary_sparse(H).shape[1],
            "k": max(L.shape[0], 1),
        }
        self.seed = seed
        self.calls = 0
        self.counters = np.zeros(4, np.int64)

    def run(self, samples: int) -> Dict:
        from ldpc_tpu_torch.monte_carlo_simulation.data_utils import (
            calculate_error_rates,
        )

        while self.counters[0] < samples:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(call_seed(self.seed, self.calls))
            out = self._step(gen)
            self.calls += 1
            self.counters += out.cpu().numpy()
        runs, fails, iters, windows = map(int, self.counters)
        ler, ler_eb, wer, wer_eb = calculate_error_rates(
            runs - fails, runs, self.code_params
        )
        side = "z" if self.check_side == "X" else "x"
        return {
            f"{side}_ler": ler,
            f"{side}_ler_eb": ler_eb,
            f"{side}_wer": wer,
            f"{side}_wer_eb": wer_eb,
            f"{side}_success_cnt": runs - fails,
            "nr_runs": runs,
            "p": self.per,
            "s": self.ser,
            "bp_iterations": iters / max(windows, 1),
            "windows_decoded": windows,
        }

    def checkpoint(self) -> Dict:
        return {
            "seed": self.seed,
            "calls": self.calls,
            "counters": self.counters.tolist(),
        }

    def restore(self, state: Dict) -> None:
        self.seed = int(state["seed"])
        self.calls = int(state["calls"])
        self.counters = np.asarray(state["counters"], np.int64)
