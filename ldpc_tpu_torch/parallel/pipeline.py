"""Pipeline parallelism: BP stage and OSD stage on two groups of mesh
entries (port of ``ldpc_tpu.parallel.pipeline``).

The default configuration keeps both stages on one device with a
compaction step between them (``device_mc.make_mc_decoder_step``,
``BpOsdDecoder.decode_batch``). This module is the pipelined variant for
deployments where BP and the GF(2) elimination run on different devices.

Design (GPipe, over a ``stage`` mesh axis of size 2):

- Microbatches of syndromes stream through a Python loop of ticks. At tick
  ``t`` the stage-0 entries run BP (K1') on microbatch ``t`` while the
  stage-1 entries run OSD-0 (K2') and the merge on microbatch ``t-1``; the
  last tick only flushes microbatch ``T-1`` through stage 1 (JAX feeds
  stage 0 a zero microbatch there and drops its result).
- The payload (syndrome, BP decoding, posteriors, convergence flag) moves
  from a stage-0 entry to its stage-1 partner with
  ``Tensor.to(device, non_blocking=True)`` on a side stream of the stage-0
  card, after a CUDA event on BP's stream; PyTorch's cross-device copy
  orders the stage-1 stream after it. No host sync a microbatch. Where the
  two stages name the same device the payload stays where it is and both
  stages run on its stream, one after the other. JAX packs the payload
  into one float32 array only because ``ppermute`` moves one array; the
  port moves the tensors as they are.
- A ``batch`` mesh axis splits each microbatch over the entries of each
  stage; payloads pair entries with equal batch coordinates.

Results equal the unpipelined decode element for element: the stages are
the same functions, the pipeline only reorders when each microbatch runs.
OSD-0 runs on every lane of a microbatch (no lane selection, so no host
sync), and BP's decoding is kept where BP converged; rows with a zero
syndrome decode to zero.
"""

from typing import Optional

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device
from ldpc_tpu_torch.helpers import convert_to_binary_sparse
from ldpc_tpu_torch.ops import bp as bp_ops
from ldpc_tpu_torch.ops import osd as osd_ops
from ldpc_tpu_torch.ops.pcm import compile_pcm
from ldpc_tpu_torch.parallel.sharding import BATCH_AXIS, Mesh

STAGE_AXIS = "stage"


def make_pipeline_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A ``(stage=2, batch=D/2)`` mesh over every visible card, or over
    ``devices`` as given (``["cuda:0", "cuda:0"]`` puts both stages on one
    card)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = list(devices)
    if len(devices) % 2:
        devices = devices[: len(devices) - 1]
    if len(devices) < 2:
        raise ValueError("pipeline parallelism needs at least 2 devices")
    return Mesh(np.asarray(devices, dtype=object).reshape(2, -1), (STAGE_AXIS, BATCH_AXIS))


def _hand_over(payload, src: torch.device, dst: torch.device, side):
    """``payload`` (tensors on ``src``, written by ``src``'s current
    stream) on ``dst``, copied on ``src``'s side stream ``side``."""
    if src == dst:
        return payload
    if src.type != "cuda" or dst.type != "cuda":
        return tuple(x.to(dst) for x in payload)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(src))
    with torch.cuda.stream(side):
        side.wait_event(ready)
        out = tuple(x.to(dst, non_blocking=True) for x in payload)
        for x in payload:
            x.record_stream(side)  # the allocator keeps them until the copy is done
    return out


def make_pipelined_decoder(
    pcm,
    error_rate: float,
    *,
    mesh: Optional[Mesh] = None,
    microbatch_size: int = 256,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    run_osd: bool = True,
):
    """Build ``decode(syndromes: (B, m) uint8) -> (B, n) uint8`` where BP
    and OSD-0 run as a two-stage pipeline over ``mesh``.

    ``mesh`` must have a ``stage`` axis of size 2 (see
    :func:`make_pipeline_mesh`); an optional ``batch`` axis adds data
    parallelism within each stage group. ``microbatch_size`` is the global
    per-tick batch (it must divide by the batch-axis size).
    """
    if mesh is None:
        mesh = make_pipeline_mesh()
    if STAGE_AXIS not in mesh.axis_names or mesh.shape[STAGE_AXIS] != 2:
        raise ValueError("mesh must have a 'stage' axis of size 2")
    # (2, nbatch): stage s, batch entry j
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(STAGE_AXIS), 0).reshape(2, -1)
    nbatch = grid.shape[1]
    if microbatch_size % nbatch:
        raise ValueError(
            f"microbatch_size {microbatch_size} must divide by the "
            f"batch-axis size {nbatch}"
        )

    pcm = convert_to_binary_sparse(pcm)
    graph = compile_pcm(pcm)
    m, n = graph.m, graph.n
    channel = np.full(n, error_rate)
    llr_np = bp_ops.channel_llr(channel)
    method = bp_ops.MINIMUM_SUM if str(bp_method).lower() in (
        "ms", "min_sum", "minimum_sum", "1",
    ) else bp_ops.PRODUCT_SUM
    stage0 = {
        dev: (bp_ops.make_parallel_decoder(graph, method, max_iter, ms_scaling_factor, dev),
              torch.from_numpy(llr_np).to(dev))
        for dev in dict.fromkeys(grid[0])
    }
    osd = {
        dev: osd_ops.make_osd_decoder(graph, channel, osd_ops.OSD_0, 0, dev)
        for dev in dict.fromkeys(grid[1])
    } if run_osd else {}
    sides = {dev: torch.cuda.Stream(dev) for dev in dict.fromkeys(grid[0])
             if dev.type == "cuda"}

    def bp_stage(j, syn):
        bp_fn, init_llr = stage0[grid[0, j]]
        r = bp_fn(syn, init_llr)
        return syn, r.decoding, r.llr_posterior, r.converged

    def osd_stage(j, payload):
        syn, dec, llr, conv = payload
        out = dec
        if run_osd:
            x0 = osd[grid[1, j]](syn, llr)[0]
            out = torch.where(conv[:, None], dec, x0)
        return out * syn.any(dim=1, keepdim=True).to(torch.uint8)

    def decode(syndromes: np.ndarray) -> np.ndarray:
        syndromes = np.atleast_2d(np.asarray(syndromes, np.uint8))
        B0 = syndromes.shape[0]
        if syndromes.shape[1] != m:
            raise ValueError(
                f"syndromes must have shape (batch, {m}), not {syndromes.shape}"
            )
        mb = microbatch_size
        mbl = mb // nbatch
        T = -(-B0 // mb)
        pad = T * mb - B0
        if pad:
            syndromes = np.concatenate([syndromes, np.zeros((pad, m), np.uint8)])
        # (T, nbatch, mbl, m): microbatch t's slice j goes to batch entry j
        chunks = torch.from_numpy(syndromes.reshape(T, nbatch, mbl, m))
        outs = [[None] * nbatch for _ in range(T)]
        in_flight = [None] * nbatch  # the payload stage 1 takes next
        for t in range(T + 1):
            sent = [None] * nbatch
            for j in range(nbatch):
                if t < T:
                    src = grid[0, j]
                    sent[j] = bp_stage(j, chunks[t, j].to(src, non_blocking=True))
                if t > 0:
                    outs[t - 1][j] = osd_stage(j, in_flight[j])
            for j in range(nbatch):
                if t < T:
                    in_flight[j] = _hand_over(sent[j], grid[0, j], grid[1, j],
                                              sides.get(grid[0, j]))
        out = torch.cat([x.cpu() for row in outs for x in row]).numpy()
        return out[:B0]

    return decode
