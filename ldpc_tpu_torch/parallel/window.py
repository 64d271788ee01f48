"""Sliding-window decoding of recorded syndrome histories on the device.

Port of ``ldpc_tpu.parallel.window``. The
measurement-rounds axis is the "sequence length" of circuit-level
decoding: ``repetitions`` noisy rounds are decoded jointly on the
space-time PCM (``build_multiround_pcm``), and the window slides by
committing its first half. :func:`make_window_decoder` decodes a batch of
shots window by window, a Python loop of launches over device tensors:

    carries -> difference syndromes -> BP (K1') -> OSD-0 (K2') or LSD-0
    (K4', through the growth loop) on the lanes BP leaves unconverged ->
    commit the first half -> carry the commit's syndrome and the
    time-boundary bit into the next window

Window semantics (those of ``decode_multiround``, reference
memory_experiment_v2.py:72-160):

- windows cover ``W = repetitions`` rounds and slide by ``T = W//2``;
- the decoded space correction of the first ``T`` rounds (XOR over
  rounds) commits; the last window commits all ``W`` rounds;
- the committed correction's syndrome ``H @ commit`` is XORed into every
  later round's syndrome (recorded data: corrections are never fed back
  into the device under test, so the carry accumulates);
- the committed time-correction of round ``T-1`` is XORed into the first
  column of the next window (reference memory_experiment_v2.py:141-144).

In analog mode the time-like bits of each window take per-shot priors
``|2 a / sigma^2|`` of the analog syndrome values ``a``, so the window's BP
runs with a ``(B, n3d)`` prior (K1''s per-lane prior).

:func:`make_rounds_sharded_window_decoder` splits the windows over the
entries of a mesh axis (sequence parallelism along the rounds): the same
window steps, placed on a chain of entries, with the inter-window carry
handed from entry to entry.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.monte_carlo_simulation.memory_experiment import (
    build_multiround_pcm,
)
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.ops.pcm import compile_pcm
from ldpc_tpu_torch.utils.profiling import count, span, sync

ROUNDS_AXIS = "rounds"


class WindowDecodeResult(NamedTuple):
    """Result of a multi-window decode.

    correction: (B, n) uint8 — total committed data correction (XOR of
        every window's commit), the analog of the accumulated ``corr``
        in QssSimulator._single_sample.
    bp_iterations: (B,) int32 — BP iterations summed over windows.
    """

    correction: torch.Tensor
    bp_iterations: torch.Tensor


def mod2_matmul(x_u8: torch.Tensor, At_f32: torch.Tensor) -> torch.Tensor:
    """(B, k) 0/1 @ (k, j) 0/1 float32 -> (B, j) uint8, mod 2."""
    y = x_u8.to(torch.float32) @ At_f32
    return (y - 2.0 * torch.floor(y * 0.5)).to(torch.uint8)


class _WindowCore(NamedTuple):
    m: int
    n: int
    W: int
    T: int
    n_space: int  # n * W, the space-variable block size of H3D
    Ht_f32: torch.Tensor  # (n, m) f32, base-PCM transpose for carry syndromes
    llr_mid: torch.Tensor  # (n3d,) priors for non-final windows
    llr_last: torch.Tensor  # (n3d,) priors for the final (perfect) window
    llr_space: torch.Tensor  # (n_space,) space-block priors (analog mode)
    llr_time_last: torch.Tensor  # f32 scalar prior for the perfect last round
    analog_scale: Optional[torch.Tensor]  # f32 scalar 2 / sigma**2 (analog mode)
    window_decode: object  # fn(s_win, init_llr) -> (decoding, iterations)
    device: torch.device


def _postprocess(post, syn: torch.Tensor, bp: bp_ops.BpResult,
                 cause: str = "window_select") -> torch.Tensor:
    """BP's decoding where BP converged, the post-processor's elsewhere.

    The post-processor runs on the unconverged lanes only: a lane's result
    does not depend on the other lanes, so every output equals running it
    on every lane and keeping BP's decoding where BP converged, as the JAX
    package does. Selecting the lanes is one host sync, ``sync.<cause>``."""
    with sync(cause):
        idx = torch.nonzero(~bp.converged).squeeze(1)
    if not idx.numel():
        return bp.decoding
    x = post(syn[idx], bp.llr_posterior[idx])
    return bp.decoding.index_put((idx,), x)


def _build_core(
    pcm,
    repetitions: int,
    data_channel,
    syndr_channel,
    *,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    osd: bool = True,
    postprocess: str = "osd0",
    bits_per_step: int = 1,
    sigma: Optional[float] = None,
    last_round_rate: float = 1e-15,
    device="cuda",
) -> _WindowCore:
    """Compile the space-time PCM and build the per-window decode engine.

    ``postprocess`` selects the BP fallback inside each window: ``"osd0"``
    (default, the reference OWD's BpOsd flavour) or ``"lsd0"`` (cluster
    decoding guided by the window BP's posteriors)."""
    if repetitions % 2 != 0:
        raise ValueError("repetitions must be even")
    if postprocess not in ("osd0", "lsd0"):
        raise ValueError(
            f"window postprocess must be 'osd0' or 'lsd0', not {postprocess}"
        )
    device = resolve_device(device)
    pcm = convert_to_binary_sparse(pcm)
    m, n = pcm.shape
    W = repetitions
    T = W // 2
    H3D = build_multiround_pcm(pcm, W - 1)
    graph3d = compile_pcm(H3D)
    n_space = n * W

    data_channel = np.broadcast_to(np.asarray(data_channel, np.float64), (n,))
    syndr_channel = np.broadcast_to(np.asarray(syndr_channel, np.float64), (m,))
    channel_mid = np.concatenate(
        [np.tile(data_channel, W), np.tile(syndr_channel, W)]
    )
    channel_last = channel_mid.copy()
    channel_last[-m:] = last_round_rate  # the final round is perfect

    def on_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    method = (
        bp_ops.MINIMUM_SUM
        if str(bp_method).lower() in ("ms", "min_sum", "minimum_sum", "1")
        else bp_ops.PRODUCT_SUM
    )
    bp_fn = bp_ops.make_parallel_decoder(
        graph3d, method, max_iter, ms_scaling_factor, device
    )
    post = None
    if osd and postprocess == "osd0":
        from ldpc_tpu_torch.ops import osd as osd_ops

        _osd = osd_ops.make_osd_decoder(graph3d, channel_mid, osd_ops.OSD_0, 0, device)

        def post(syn, llr):
            count("window.lanes.post", syn.shape[0])
            return _osd(syn, llr)[0]

    elif osd:
        from ldpc_tpu_torch.ops import lsd as lsd_ops

        _lsd = lsd_ops.make_lsd_decoder(
            graph3d, lsd_method=lsd_ops.LSD_0, lsd_order=0,
            bits_per_step=bits_per_step, device=device,
        )

        def post(syn, llr):
            count("window.lanes.post", syn.shape[0])
            return _lsd(syn, llr)[0]

    def window_decode(syn_flat, init_llr):
        """Decode one window: (B, m*W) round-major difference syndromes ->
        ((B, n3d) uint8 decoding, (B,) int32 iterations)."""
        bp = bp_fn(syn_flat, init_llr)
        if post is None:
            return bp.decoding, bp.iterations
        return _postprocess(post, syn_flat, bp), bp.iterations

    # the carry syndromes are 0/1 matmuls in f32, held to full f32 as in
    # device_mc
    torch.backends.cuda.matmul.allow_tf32 = False
    analog_scale = None
    if sigma is not None:
        # the JAX package's jitted |2 a / sigma^2|, with sigma a constant:
        # XLA turns the division by the constant sigma^2 into a product
        # with its float32 reciprocal and folds the 2 into it, so the prior
        # is |a * (2 * (1 / sigma^2))|, each step rounded in float32
        s32 = np.float32(sigma)
        scale = np.float32(2.0) * (np.float32(1.0) / (s32 * s32))
        analog_scale = torch.tensor(scale, device=device)
    return _WindowCore(
        m=m,
        n=n,
        W=W,
        T=T,
        n_space=n_space,
        Ht_f32=on_device(np.asarray(pcm.todense(), np.float32).T),
        llr_mid=on_device(bp_ops.channel_llr(channel_mid)),
        llr_last=on_device(bp_ops.channel_llr(channel_last)),
        llr_space=on_device(bp_ops.channel_llr(np.tile(data_channel, W))),
        llr_time_last=torch.tensor(
            bp_ops.channel_llr(np.asarray([last_round_rate]))[0], device=device
        ),
        analog_scale=analog_scale,
        window_decode=window_decode,
        device=device,
    )


def _window_prior(core: _WindowCore, is_last: bool, analog_win=None) -> torch.Tensor:
    """The window BP's prior: (n3d,) in binary mode; in analog mode (B,
    n3d), the space block's channel priors beside ``|2 a / sigma^2|`` of
    the (B, m, W) analog values ``a``, rounded in float32 as the JAX
    package's jitted window rounds it (see ``analog_scale``). The perfect
    last round pins the final block."""
    if analog_win is None:
        return core.llr_last if is_last else core.llr_mid
    B = analog_win.shape[0]
    m, W = core.m, core.W
    a_flat = analog_win.transpose(1, 2).reshape(B, W * m)
    llr_t = torch.abs(a_flat * core.analog_scale)
    if is_last:
        llr_t[:, (W - 1) * m :] = core.llr_time_last
    return torch.cat([core.llr_space.expand(B, core.n_space), llr_t], dim=1)


def _decode_window(core: _WindowCore, s_win, is_last: bool, analog_win=None):
    """Difference syndromes of the (B, m, W) window (carries applied),
    decoded: ``(commit (B, n) uint8, time-boundary bits (B, m) uint8,
    iterations (B,) int32)``. The span ``window.step``; counts
    ``window.windows`` and, on a per-lane prior, ``window.windows.analog``."""
    m, n, W, T = core.m, core.n, core.W, core.T
    B = s_win.shape[0]
    count("window.windows")
    if analog_win is not None:
        count("window.windows.analog")
    with span("window.step", lanes=B):
        # difference syndromes along the time axis (memory_experiment_v2.py:93-94)
        diff = torch.cat([s_win[:, :, :1], s_win[:, :, 1:] ^ s_win[:, :, :-1]], dim=2)
        syn_flat = diff.transpose(1, 2).reshape(B, W * m)  # round-major
        decoding, iters = core.window_decode(
            syn_flat, _window_prior(core, is_last, analog_win)
        )
        space = decoding[:, : core.n_space].reshape(B, W, n)
        n_commit = W if is_last else T
        commit = (space[:, :n_commit].sum(dim=1) % 2).to(torch.uint8)
        tb = decoding[:, core.n_space :].reshape(B, W, m)[:, T - 1, :]
    return commit, tb, iters


def _window_step(core: _WindowCore, carry, s_win, is_last: bool, analog_win=None):
    """One window of the loop: apply carries, diff, decode, commit.

    carry = (carry_syn (B,m) u8, tb (B,m) u8, total (B,n) u8, iters (B,)
    i32). ``s_win`` is the raw (B, m, W) slice of the recorded history."""
    carry_syn, tb, total, iters_tot = carry
    s_win = s_win ^ carry_syn[:, :, None]
    s_win[:, :, 0] ^= tb
    commit, tb_new, iters = _decode_window(core, s_win, is_last, analog_win)
    total = total ^ commit
    carry_syn = carry_syn ^ mod2_matmul(commit, core.Ht_f32)
    return carry_syn, tb_new, total, iters_tot + iters


def make_window_decoder(
    pcm,
    repetitions: int,
    data_channel,
    syndr_channel,
    *,
    sigma: Optional[float] = None,
    device="cuda",
    **engine_kwargs,
):
    """Build a batched multi-window decoder on ``device``.

    Returns ``decode(syndromes, analog=None) -> WindowDecodeResult`` where
    ``syndromes`` is ``(B, m, R)`` uint8 — the recorded cumulative
    syndrome history of ``R = (n_windows + 1) * repetitions//2`` rounds
    (final round perfect, as in a standard memory experiment) — and
    ``analog`` optionally carries (B, m, R) analog syndrome values, cast
    to float32 (requires ``sigma``; reference quasi_single_shot_v2
    analog_tg mode). ``engine_kwargs``: ``max_iter``, ``bp_method``,
    ``ms_scaling_factor``, ``osd``, ``postprocess`` (``"osd0"`` or
    ``"lsd0"``), ``bits_per_step``, ``last_round_rate``.

    The results stay on the device. The OSD-0 engine syncs with the host
    once a window (to pick the lanes BP leaves unconverged); the LSD-0
    engine also syncs once a growth round.

    Recorded (``utils/profiling.py``): the span ``window.decode`` a call
    (counter ``window.shots``) over a ``window.step`` a window
    (``window.windows``, ``window.windows.analog``; ``sync.window_select``
    and the post-processor's spans nest in it), and ``window.lanes.post``,
    the lanes handed to OSD-0 or LSD-0.
    """
    core = _build_core(
        pcm, repetitions, data_channel, syndr_channel, sigma=sigma,
        device=device, **engine_kwargs,
    )
    m, n, W, T = core.m, core.n, core.W, core.T
    dev = core.device

    def decode(syndromes, analog=None) -> WindowDecodeResult:
        with span("window.decode", lanes=len(syndromes)):
            syndromes = torch.as_tensor(syndromes, device=dev).to(torch.uint8)
            B, m_, R = syndromes.shape
            if m_ != m:
                raise ValueError(f"syndromes rows {m_} != checks {m}")
            if R < W or (R - W) % T:
                raise ValueError(
                    f"history of {R} rounds does not tile into windows of "
                    f"{W} sliding by {T}"
                )
            if analog is not None:
                if core.analog_scale is None:
                    raise ValueError("analog syndromes need the decoder's sigma")
                analog = torch.as_tensor(analog, device=dev).to(torch.float32)
                if analog.shape != syndromes.shape:
                    raise ValueError(
                        f"analog shape {tuple(analog.shape)} != syndromes shape "
                        f"{tuple(syndromes.shape)}"
                    )
            count("window.shots", B)
            NW = (R - W) // T + 1
            carry = (
                torch.zeros((B, m), dtype=torch.uint8, device=dev),
                torch.zeros((B, m), dtype=torch.uint8, device=dev),
                torch.zeros((B, n), dtype=torch.uint8, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev),
            )
            for w in range(NW):
                rounds = slice(w * T, w * T + W)
                a_win = analog[:, :, rounds] if analog is not None else None
                carry = _window_step(core, carry, syndromes[:, :, rounds], w == NW - 1, a_win)
            _, _, total, iters = carry
            return WindowDecodeResult(correction=total, bp_iterations=iters)

    return decode


def make_rounds_sharded_window_decoder(
    pcm,
    repetitions: int,
    data_channel,
    syndr_channel,
    *,
    mesh,
    n_windows: int,
    microbatches: int = 4,
    axis_name: Optional[str] = None,
    **engine_kwargs,
):
    """Rounds-axis (sequence) parallel window decoding over a mesh.

    Entry ``d`` of the ``axis_name`` mesh axis owns windows
    ``[d*wpd, (d+1)*wpd)`` (``wpd = n_windows / D``) and holds only its
    halo'd slice of the syndrome history, ``(wpd + 1) * T`` rounds. Shots
    stream through the chain of entries in ``microbatches`` chunks on a
    GPipe schedule: at tick ``t`` entry ``d`` decodes microbatch ``t - d``
    through its windows (:func:`_window_step`, the single-device decoder's
    step), then hands the inter-window carry (the committed correction's
    syndrome and the time-boundary bit) to entry ``d+1``
    (:func:`~ldpc_tpu_torch.parallel.sharding.ppermute`). A shot's commits
    are disjoint across entries, so the total correction is one sum mod 2
    at the end, and the iterations one sum. Where the entries are distinct
    cards, each tick's entries run at once
    (:func:`~ldpc_tpu_torch.parallel.sharding.run_entries`).

    The result equals :func:`make_window_decoder`'s bit for bit: the same
    (window, shot) computations run, only their placement changes.
    ``engine_kwargs`` are :func:`make_window_decoder`'s (binary mode).
    Returns ``decode(syndromes (B, m, R) uint8) -> WindowDecodeResult`` on
    the first entry's device (``B`` must divide by ``microbatches``,
    ``R = (n_windows + 1) * T``).
    """
    from ldpc_tpu_torch.parallel.sharding import ppermute, psum, run_entries

    if axis_name is None:
        axis_name = ROUNDS_AXIS if ROUNDS_AXIS in mesh.axis_names else mesh.axis_names[0]
    devices = mesh.axis_devices(axis_name)
    D = len(devices)
    NW = int(n_windows)
    if NW % D:
        raise ValueError(f"n_windows={NW} must divide evenly over {D} mesh devices")
    cores = {
        dev: _build_core(pcm, repetitions, data_channel, syndr_channel, device=dev,
                         **engine_kwargs)
        for dev in dict.fromkeys(devices)
    }
    core = cores[devices[0]]
    m, n, T = core.m, core.n, core.T
    wpd = NW // D
    LR = (wpd + 1) * T  # local rounds incl. the right halo
    R = (NW + 1) * T
    M = int(microbatches)

    def decode(syndromes) -> WindowDecodeResult:
        syndromes = torch.as_tensor(syndromes).to(torch.uint8)
        B, m_, R_ = syndromes.shape
        if m_ != m or R_ != R:
            raise ValueError(
                f"expected (B, {m}, {R}) syndromes for n_windows={NW}, "
                f"got {tuple(syndromes.shape)}"
            )
        if B % M:
            raise ValueError(f"batch {B} must divide by microbatches={M}")
        mbs = B // M
        slabs = [syndromes[:, :, d * wpd * T: d * wpd * T + LR].to(dev)
                 for d, dev in enumerate(devices)]
        totals = [torch.zeros((B, n), dtype=torch.uint8, device=dev) for dev in devices]
        iters = [torch.zeros((B,), dtype=torch.int32, device=dev) for dev in devices]
        # entry 0 starts every microbatch's chain from a zero carry
        carry_in = [None] * D

        def local_windows(d, t):
            """Entry d's windows on microbatch t - d; its carry out."""
            mb = t - d
            if not 0 <= mb < M:
                return None
            dev, rows = devices[d], slice(mb * mbs, (mb + 1) * mbs)
            if d == 0:
                zero = torch.zeros((mbs, m), dtype=torch.uint8, device=dev)
                carry_in[0] = (zero, zero)
            carry = (*carry_in[d], torch.zeros((mbs, n), dtype=torch.uint8, device=dev),
                     torch.zeros((mbs,), dtype=torch.int32, device=dev))
            for wl in range(wpd):
                s_win = slabs[d][rows, :, wl * T: wl * T + core.W]
                carry = _window_step(cores[dev], carry, s_win, d * wpd + wl == NW - 1)
            carry_syn, tb, totals[d][rows], iters[d][rows] = carry
            return carry_syn, tb

        for t in range(M + D - 1):
            carry_out = run_entries(devices, lambda d: local_windows(d, t))
            # entry d's carry goes on to entry d+1 (entry 0 drops what the
            # ring brings back to it)
            carry_in = ppermute([() if c is None else c for c in carry_out], devices)
        total = psum([x.to(torch.int32) for x in totals], devices)[0] % 2
        return WindowDecodeResult(
            correction=total.to(torch.uint8), bp_iterations=psum(iters, devices)[0])

    return decode
