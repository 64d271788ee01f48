"""Kernel K1': batched parallel-schedule BP (counterpart of ``ops/bp_pallas.py``).

- :func:`bp_parallel_reference` is the plain PyTorch version: the
  gather-only engine of ``ldpc_tpu/ops/bp.py`` (``_make_parallel_decoder_
  fast``), op for op, in the dtype of ``init_llr``, which is one ``(n,)``
  prior for every lane or a ``(B, n)`` prior, a row a lane. With
  ``dynamic_alpha=False`` it is the single-scan engine
  (``make_single_scan_decoder``): min-sum keeps the fixed factor even at 0.
- :func:`bp_parallel_cuda` launches ``csrc/bp_parallel.cu`` on a CUDA
  tensor: float32 (both methods) or float64 (min-sum, single-scan's
  instance). It counts the launch under ``launch.bp_parallel``, by where
  the lanes' state lived, by dtype and, when the prior is ``(B, n)``, under
  ``launch.bp_parallel.lane_prior`` (the recorder's table:
  ``ldpc_tpu_torch.utils.profiling``).
- :func:`bp_parallel` picks by the tensors' device: the CPU runs the plain
  version, a CUDA device runs the kernel, anything else raises.
"""

from typing import Optional

import torch

from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.bp import MINIMUM_SUM, BpResult
from ldpc_tpu_torch.ops.pcm import TorchGraph
from ldpc_tpu_torch.utils.profiling import count

_BIG = 1e30  # magnitude of absent slots in the min-sum reduction
_MAX_DC = 32  # largest row degree the kernel is instantiated for


def _check_to_bit_min_sum(v2c3, mask3, syndrome, alpha):
    """Min-sum check update over the dc axis of (m, dc, B) messages."""
    big = torch.tensor(_BIG, dtype=v2c3.dtype, device=v2c3.device)
    absv = torch.where(mask3, v2c3.abs(), big)
    neg = (mask3 & (v2c3 <= 0)).to(torch.int32)
    min1 = absv.min(dim=1).values
    amin = absv.argmin(dim=1)  # first occurrence
    slot = torch.arange(v2c3.shape[1], device=v2c3.device)[None, :, None]
    is_min = slot == amin[:, None, :]
    min2 = torch.where(is_min, big, absv).min(dim=1).values
    total_par = (syndrome[:, None, :] + neg.sum(dim=1, keepdim=True) + neg) % 2
    excl_min = torch.where(is_min, min2[:, None, :], min1[:, None, :])
    sign = (1 - 2 * total_par).to(v2c3.dtype)
    return torch.where(mask3, alpha * sign * excl_min, 0.0)


def _check_to_bit_product_sum(v2c3, mask3, syndrome):
    """Product-sum check update: exclusive prefix/suffix tanh products,
    clipped away from +-1 in float32 (float64 saturates to inf, as the
    JAX engine does)."""
    t = torch.where(mask3, torch.tanh(v2c3 * 0.5), 1.0)
    ones = torch.ones_like(t[:, :1, :])
    prefix = torch.cat([ones, torch.cumprod(t, dim=1)[:, :-1, :]], dim=1)
    rev = torch.flip(t, dims=[1])
    suffix = torch.flip(
        torch.cat([ones, torch.cumprod(rev, dim=1)[:, :-1, :]], dim=1), dims=[1]
    )
    p = prefix * suffix
    if p.dtype == torch.float32:
        eps = torch.tensor(1e-7, dtype=torch.float32, device=v2c3.device)
        p = torch.clamp(p, -1 + eps, 1 - eps)
    mag = torch.log((1 + p) / (1 - p))
    sign = (1 - 2 * syndrome[:, None, :]).to(p.dtype)
    return torch.where(mask3, sign * mag, 0.0)


def bp_parallel_reference(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    dynamic_alpha: bool = True,
) -> BpResult:
    """Plain PyTorch parallel-schedule BP on (B, m) uint8 syndromes, in the
    dtype of ``init_llr`` (float32 or float64): an (n,) prior shared by the
    lanes or a (B, n) prior, one row a lane."""
    m, n, dc, dv = tg.m, tg.n, tg.dc, tg.dv
    E = m * dc
    B = syndromes.shape[0]
    dev = syndromes.device
    dt = init_llr.dtype
    chk_bits = tg.chk_bits.reshape(-1).long()  # (E,) pad = n
    var_edges = tg.var_edges.reshape(-1).long()  # (n*dv,) pad = E
    mask3 = tg.chk_mask[:, :, None]
    syndrome = syndromes.t().to(torch.int32)  # (m, B)
    llr_col = init_llr.t() if init_llr.dim() == 2 else init_llr[:, None]  # (n, B) or (n, 1)
    zero_row = torch.zeros((1, B), dtype=dt, device=dev)
    false_row = torch.zeros((1, B), dtype=torch.bool, device=dev)

    llr_post = llr_col.expand(n, B)
    c2v = torch.zeros((m, dc, B), dtype=dt, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    dec_out = torch.zeros((n, B), dtype=torch.bool, device=dev)
    llr_out = llr_post.clone()
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(conv.all()):
        it += 1
        if dynamic_alpha and bp_method == MINIMUM_SUM and ms_scaling_factor == 0.0:
            alpha = torch.tensor(1.0 - 2.0**-it, dtype=dt, device=dev)
        else:
            alpha = torch.tensor(ms_scaling_factor, dtype=dt, device=dev)
        llr_pad = torch.cat([llr_post, zero_row])
        v2c3 = llr_pad[chk_bits].reshape(m, dc, B) - c2v  # extrinsic
        if bp_method == MINIMUM_SUM:
            c2v = _check_to_bit_min_sum(v2c3, mask3, syndrome, alpha)
        else:
            c2v = _check_to_bit_product_sum(v2c3, mask3, syndrome)
        c2v_pad = torch.cat([c2v.reshape(E, B), zero_row])
        per_bit = c2v_pad[var_edges].reshape(n, dv, B)
        acc = per_bit[:, 0]  # slot order, as the kernel sums
        for k in range(1, dv):
            acc = acc + per_bit[:, k]
        llr_new = llr_col + acc
        hard = llr_new <= 0
        hard_pad = torch.cat([hard, false_row])
        cand = hard_pad[chk_bits].reshape(m, dc, B).sum(dim=1) % 2
        conv_now = (cand == syndrome).all(dim=0)
        active = ~conv
        dec_out = torch.where(active[None, :], hard, dec_out)
        llr_out = torch.where(active[None, :], llr_new, llr_out)
        iters = torch.where(active, it, iters)
        conv = conv | conv_now
        llr_post = llr_new
    return BpResult(
        decoding=dec_out.t().to(torch.uint8),
        llr_posterior=llr_out.t(),
        converged=conv,
        iterations=iters,
    )


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"bp_parallel_cuda: {what}")


def state_variant(m: int, n: int, dc: int, dtype=torch.float32) -> str:
    """Where K1 keeps a lane's state by default: ``"shared"`` memory while
    it fits the kernel's per-lane budget, else a lane-major scratch in
    ``"device"`` memory (same kernel template, still one warp per lane).
    The layout and the budget live in ``csrc/bp_parallel.cu``, so this
    builds the kernels' library."""
    elem = torch.empty((), dtype=dtype).element_size()
    return "shared" if _build.library().ldpc_bp_shared_state(m, n, dc, elem) else "device"


def bp_parallel_cuda(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    state: Optional[str] = None,
    dynamic_alpha: bool = True,
) -> BpResult:
    """Launch K1' (``csrc/bp_parallel.cu``) on CUDA tensors: one warp per
    lane, several lanes per block. float32 runs either method; float64 (the
    dtype of ``init_llr``) runs min-sum, the single-scan engine's instance.
    ``init_llr`` is one (n,) prior or a (B, n) prior, a row a lane.
    ``state`` forces where a lane's state lives (``"shared"`` or
    ``"device"``; tests only); by default :func:`state_variant` chooses by
    footprint."""
    dev = syndromes.device
    m, n, dc, dv = tg.m, tg.n, tg.dc, tg.dv
    _require(dev.type == "cuda", f"syndromes must be on a CUDA device, not {dev}")
    for name, t in (
        ("syndromes", syndromes),
        ("init_llr", init_llr),
        ("chk_bits_t", tg.chk_bits_t),
        ("var_edges_t", tg.var_edges_t),
    ):
        _require(t.device == dev, f"{name} is on {t.device}, syndromes on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(syndromes.dtype == torch.uint8, "syndromes must be uint8")
    _require(
        syndromes.dim() == 2 and syndromes.shape[1] == m,
        f"syndromes must have shape (B, {m}), not {tuple(syndromes.shape)}",
    )
    dt = init_llr.dtype
    _require(dt in (torch.float32, torch.float64), "init_llr must be float32 or float64")
    _require(
        dt == torch.float32 or bp_method == MINIMUM_SUM,
        "float64 runs min-sum only (product-sum in float64 is K8')",
    )
    B = syndromes.shape[0]
    per_lane = init_llr.dim() == 2
    _require(
        init_llr.shape in ((n,), (B, n)),
        f"init_llr must have shape ({n},) or ({B}, {n}), not {tuple(init_llr.shape)}",
    )
    _require(tg.chk_bits_t.dtype == torch.int32, "chk_bits_t must be int32")
    _require(tg.var_edges_t.dtype == torch.int32, "var_edges_t must be int32")
    _require(dc <= _MAX_DC, f"row degree {dc} exceeds {_MAX_DC}")
    _require(max_iter >= 0, "max_iter must be >= 0")
    state = state_variant(m, n, dc, dt) if state is None else state
    _require(state in ("shared", "device"), "state must be 'shared' or 'device'")
    shared = state == "shared"
    # the device-memory variant's c2v scratch, lane-major (B, m*dc)
    c2v = torch.empty((0 if shared else B, m * dc), dtype=dt, device=dev)
    llr = torch.empty((B, n), dtype=dt, device=dev)
    dec = torch.empty((B, n), dtype=torch.uint8, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.ldpc_bp_parallel(
                syndromes.data_ptr(), init_llr.data_ptr(), int(per_lane),
                tg.chk_bits_t.data_ptr(), tg.var_edges_t.data_ptr(),
                m, n, dc, dv, B, max_iter,
                int(bp_method == MINIMUM_SUM), float(ms_scaling_factor),
                int(dynamic_alpha), int(shared), int(dt == torch.float64),
                c2v.data_ptr(), llr.data_ptr(), dec.data_ptr(),
                conv.data_ptr(), iters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "bp_parallel")
        count("launch.bp_parallel")
        count("launch.bp_parallel." + state)
        count("launch.bp_parallel." + str(dt).removeprefix("torch."))
        if per_lane:
            count("launch.bp_parallel.lane_prior")
    return BpResult(decoding=dec, llr_posterior=llr, converged=conv, iterations=iters)


def bp_parallel(
    tg: TorchGraph,
    syndromes: torch.Tensor,
    init_llr: torch.Tensor,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    dynamic_alpha: bool = True,
) -> BpResult:
    """K1' on a CUDA tensor, its plain version on a CPU tensor."""
    kind = syndromes.device.type
    if kind == "cpu":
        return bp_parallel_reference(
            tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor,
            dynamic_alpha,
        )
    if kind == "cuda":
        return bp_parallel_cuda(
            tg, syndromes, init_llr, bp_method, max_iter, ms_scaling_factor,
            dynamic_alpha=dynamic_alpha,
        )
    raise ValueError(f"bp_parallel: no kernel for device {syndromes.device}")
