"""Batched flip / p-flip decoding (port of ``ldpc_tpu.ops.flip``; reference
src_cpp/flip.hpp).

Greedy bit flipping: sweep the bits in index order and flip any bit whose
unsatisfied checks outnumber its satisfied checks, updating the syndrome and
its weight at once (flip.hpp:95-108). On every ``pfreq``-th sweep a tie
(as many unsatisfied as satisfied checks) also flips with probability 1/2,
the p-flip rule of arXiv:2212.06985 (flip.hpp:109-123). A lane converges
when its syndrome weight reaches 0, tested after every bit
(flip.hpp:129-134); a lane that never converges reports ``max_iter``
iterations.

The sweep is sequential per lane, so it runs as one kernel
(``csrc/flip.cu``, :func:`flip_cuda`, launches counted under
``launch.flip``) in which a warp scans a lane's bits 32 at a time
and applies the first flip it finds;
:func:`flip_reference` is its plain PyTorch version, vectorised over the
lanes one bit at a time, :func:`flip_scan_reference` the plain model of the
kernel's scan, and :func:`flip` picks by the tensors' device: the CPU runs
the plain version, a CUDA device the kernel, anything else raises.

Two choices of the port, shared by both versions:

- **Fixpoint exit.** Without p-flip a sweep that flips nothing leaves the
  state as it found it, so every later sweep flips nothing either; such a
  lane stops, with the outputs the remaining sweeps would give.
- **The p-flip coin** is not ``jax.random``: it is the top bit of a
  counter-based 32-bit hash of (seed, lane, sweep, bit), :func:`coin`,
  computed the same way in the kernel and here, so the two agree bit for bit
  with ``pfreq > 0`` too. The hash runs in int64 with masks, since torch on
  the CPU has no shifts on uint32.
"""

from typing import Tuple

import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.ops import _build
from ldpc_tpu_torch.ops.pcm import PcmGraph, TorchGraph, graph_to_torch
from ldpc_tpu_torch.utils.profiling import count

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can opt in to

_M32 = 0xFFFFFFFF

FlipResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _mul32(x, c: int):
    """``x * c mod 2**32`` for 0 <= x < 2**32, exact in int64: the product
    is split at 16 bits of ``c`` so no partial product reaches 2**63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The ``lowbias32`` integer hash (uint32 in, uint32 out)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def coin(seed: int, lanes, sweep: int, bit):
    """The p-flip coin of (seed, lane, sweep, bit): the top bit of
    ``mix(mix(mix(mix(seed) ^ lane) ^ sweep) ^ bit)``. ``lanes`` and ``bit``
    are ints or int64 tensors that broadcast; ints give a bool, tensors a
    bool tensor."""
    h = _mix32(_mix32(_mix32(_mix32(seed & _M32) ^ lanes) ^ sweep) ^ bit)
    return (h >> 31) == 1


def flip_reference(
    tg: TorchGraph, syndromes: torch.Tensor, max_iter: int, pfreq: int, seed: int
) -> FlipResult:
    """Plain PyTorch flip sweep on (B, m) uint8 syndromes: one bit at a time
    over all lanes. Returns ``(decoding (B, n) uint8, converged (B,) bool,
    iterations (B,) int32)``."""
    B = syndromes.shape[0]
    dev = syndromes.device
    synd = syndromes.bool().clone()
    dec = torch.zeros((B, tg.n), dtype=torch.uint8, device=dev)
    weight = syndromes.sum(dim=1, dtype=torch.int64)
    conv = weight == 0
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    live = ~conv  # lanes still sweeping
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    var_chks = tg.var_chks.cpu()
    var_mask = tg.var_mask.cpu()
    chks = [var_chks[j][var_mask[j]].long().to(dev) for j in range(tg.n)]
    it = 0
    while it < max_iter and bool(live.any()):
        it += 1
        pflip = pfreq > 0 and it % pfreq == 0
        flipped = torch.zeros(B, dtype=torch.bool, device=dev)
        for j, c in enumerate(chks):
            s = synd[:, c]
            unsat = s.sum(dim=1)
            sat = c.numel() - unsat
            do = unsat > sat
            if pflip:
                do |= (sat == unsat) & coin(seed, lanes, it, j)
            do &= live
            dec[:, j] ^= do.to(torch.uint8)
            synd[:, c] = s ^ do[:, None]
            weight += torch.where(do, sat - unsat, 0)
            hit = do & (weight == 0)
            iters = torch.where(hit, it, iters)
            conv |= hit
            live &= ~hit
            flipped |= do
        if pfreq == 0:
            live &= flipped  # the others are at a fixpoint
    iters = torch.where(conv, iters, max_iter).to(torch.int32)
    return dec, conv, iters


def flip_scan_reference(
    tg: TorchGraph, syndromes: torch.Tensor, max_iter: int, pfreq: int, seed: int,
    group: int,
) -> FlipResult:
    """Plain PyTorch model of the kernel's scan, equal to
    :func:`flip_reference` bit for bit; no decoder calls it.

    Each lane decides ``group`` bits of the sweep at once against its
    current syndrome, applies only the first of them that flips, and resumes
    at the bit after it (``group`` bits on when none flips). A bit's
    decision depends only on the flips before it, so the flips, their order
    and the convergence test are those of the one-bit-at-a-time sweep.
    """
    B = syndromes.shape[0]
    m, n = tg.m, tg.n
    dev = syndromes.device
    # column m takes the pad slots of var_chks and stays 0
    synd = torch.zeros((B, m + 1), dtype=torch.bool, device=dev)
    synd[:, :m] = syndromes.bool()
    dec = torch.zeros((B, n), dtype=torch.uint8, device=dev)
    weight = syndromes.sum(dim=1, dtype=torch.int64)
    conv = weight == 0
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    live = ~conv  # lanes still sweeping
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    offsets = torch.arange(group, dtype=torch.int64, device=dev)
    var_chks = tg.var_chks.long()
    deg = tg.var_mask.sum(dim=1)
    it = 0
    while it < max_iter and bool(live.any()):
        it += 1
        pflip = pfreq > 0 and it % pfreq == 0
        flipped = torch.zeros(B, dtype=torch.bool, device=dev)
        start = torch.zeros(B, dtype=torch.int64, device=dev)  # each lane's next bit
        scanning = live.clone()  # lanes with bits of this sweep left
        while bool(scanning.any()):
            bit = start[:, None] + offsets  # (B, group)
            inside = (bit < n) & scanning[:, None]
            bit = bit.clamp(max=n - 1)
            chks = var_chks[bit]  # (B, group, dv)
            unsat = synd[lanes[:, None, None], chks].sum(dim=2)
            gain = deg[bit] - 2 * unsat  # satisfied minus unsatisfied checks
            do = gain < 0
            if pflip:
                do |= (gain == 0) & coin(seed, lanes[:, None], it, bit)
            do &= inside
            any_flip = do.any(dim=1)
            first = do.to(torch.uint8).argmax(dim=1)  # the first bit that flips
            at = lanes[any_flip]
            flip_bit = bit[at, first[at]]
            dec[at, flip_bit] ^= 1
            synd[at[:, None], var_chks[flip_bit]] ^= True
            synd[:, m] = False
            weight[at] += gain[at, first[at]]
            hit = any_flip & (weight == 0)
            iters = torch.where(hit, it, iters)
            conv |= hit
            live &= ~hit
            flipped |= any_flip
            start = torch.where(any_flip, start + first + 1, start + group)
            scanning &= ~hit & (start < n)
        if pfreq == 0:
            live &= flipped  # the others are at a fixpoint
    iters = torch.where(conv, iters, max_iter).to(torch.int32)
    return dec, conv, iters


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flip_cuda: {what}")


def flip_cuda(
    tg: TorchGraph, syndromes: torch.Tensor, max_iter: int, pfreq: int, seed: int
) -> FlipResult:
    """Launch the flip sweep (``csrc/flip.cu``) on CUDA tensors: one warp per
    lane, 8 lanes a block."""
    dev = syndromes.device
    m, n = tg.m, tg.n
    _require(dev.type == "cuda", f"syndromes must be on a CUDA device, not {dev}")
    _require(tg.var_chks.device == dev, f"var_chks is on {tg.var_chks.device}, syndromes on {dev}")
    _require(tg.var_chks.dtype == torch.int32, "var_chks must be int32")
    _require(tg.var_chks.is_contiguous(), "var_chks must be contiguous")
    _require(syndromes.is_contiguous(), "syndromes must be contiguous")
    _require(syndromes.dtype == torch.uint8, "syndromes must be uint8")
    _require(
        syndromes.dim() == 2 and syndromes.shape[1] == m,
        f"syndromes must have shape (B, {m}), not {tuple(syndromes.shape)}",
    )
    _require(max_iter >= 0, "max_iter must be >= 0")
    _require(pfreq >= 0, "pfreq must be >= 0")
    B = syndromes.shape[0]
    dec = torch.empty((B, n), dtype=torch.uint8, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.library()
        smem = lib.ldpc_flip_smem(m, n, tg.dv)
        _require(
            smem <= SMEM_LIMIT,
            f"the graph and the lanes' state need {smem} bytes of shared memory, "
            f"more than the card's {SMEM_LIMIT}",
        )
        with torch.cuda.device(dev):
            rc = lib.ldpc_flip(
                syndromes.data_ptr(), tg.var_chks.data_ptr(), m, n, tg.dv, B,
                int(max_iter), int(pfreq), int(seed) & _M32, dec.data_ptr(), conv.data_ptr(), iters.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "flip")
        count("launch.flip")
    return dec, conv, iters


def flip(
    tg: TorchGraph, syndromes: torch.Tensor, max_iter: int, pfreq: int, seed: int
) -> FlipResult:
    """The flip kernel on a CUDA tensor, its plain version on a CPU tensor."""
    kind = syndromes.device.type
    if kind == "cpu":
        return flip_reference(tg, syndromes, max_iter, pfreq, seed)
    if kind == "cuda":
        return flip_cuda(tg, syndromes, max_iter, pfreq, seed)
    raise ValueError(f"flip: no kernel for device {syndromes.device}")


def syndrome_of(tg: TorchGraph, x: torch.Tensor) -> torch.Tensor:
    """``H x mod 2`` of (B, n) uint8 decodings, exactly: an XOR over each
    check's ELL slots (a pad slot reads the zero column n). (B, m) uint8."""
    x_pad = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    return (x_pad[:, tg.chk_bits.long()].sum(dim=2) & 1).to(torch.uint8)


def make_flip_decoder(graph: PcmGraph, max_iter: int, pfreq: int, device="cuda"):
    """Build a batched flip decoder on ``device``.

    ``pfreq == 0`` turns the p-flip tie break off (the reference maps 0 to
    INT_MAX, flip.hpp:40-42). Returns ``decode(syndromes: (B, m) uint8,
    seed: int) -> (decoding (B, n) uint8, converged (B,) bool, iterations
    (B,) int32)``; the coin of row ``b`` is keyed by ``(seed, b)``.
    """
    device = resolve_device(device)
    tg = graph_to_torch(graph, device)

    def decode(syndromes: torch.Tensor, seed: int) -> FlipResult:
        syndromes = torch.as_tensor(syndromes, dtype=torch.uint8, device=device)
        return flip(tg, syndromes.contiguous(), max_iter, pfreq, seed)

    return decode
