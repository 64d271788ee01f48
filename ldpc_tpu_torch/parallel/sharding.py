"""The device mesh and batch-axis sharding helpers (port of
``ldpc_tpu.parallel.sharding``).

JAX runs one SPMD program over a ``Mesh`` of devices and puts the
collectives where the shardings need them. The port keeps a small mesh of
its own: :class:`Mesh` is an array of ``torch.device`` entries with
``axis_names`` and ``shape[axis]``, so callers written against
``ldpc_tpu.parallel.make_mesh`` read the same. A sharded program is a
Python loop that launches each entry's work on that entry's device
(:func:`run_entries`), and the in-process collectives are plain tensor
code: :func:`psum` sums the entries' tensors in entry order and copies the
sum to each entry; :func:`ppermute` copies each entry's tensor to the next
entry. Across processes, :mod:`ldpc_tpu_torch.parallel.distributed` adds
one ``torch.distributed.all_reduce`` on top of the in-process sum.
``torch.distributed.DeviceMesh`` is not used: it assumes one rank per
device, which one card or the CPU cannot give.

A mesh may name the same device more than once. This is the counterpart of
the 8 virtual CPU devices the JAX package's tests give JAX
(``--xla_force_host_platform_device_count=8``): it is how a 2-, 4- or
8-entry mesh runs on one CPU, or on one card. Entries that share a device
share its default stream and run one after another; entries on distinct
cards run at once, a host thread a card, so that one card's host syncs do
not hold back the others.
"""

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ldpc_tpu_torch.device import resolve_device

BATCH_AXIS = "batch"


def _entry_device(device) -> torch.device:
    """A mesh entry's device, checked, with a CUDA index always given (so
    that entries naming one card compare equal)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An array of devices with named axes (``jax.sharding.Mesh``'s
    surface: ``devices``, ``axis_names``, ``shape[axis]``, ``size``, and
    ``with mesh:``, which does nothing here)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of shape {grid.shape} needs {grid.ndim} axis names, "
                f"not {axis_names}"
            )
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = _entry_device(grid[idx])
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.size = int(grid.size)

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The entries along ``axis_name``, at index 0 of every other axis
        (a program sharded over one axis of a larger mesh runs there, and
        the other axes hold copies)."""
        pos = self.axis_names.index(axis_name)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[pos]):
            idx[pos] = i
            out.append(self.devices[tuple(idx)])
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = BATCH_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-D mesh over the syndrome-batch axis.

    Uses every visible card by default (and raises without one, as every
    entry point of the port does), or ``devices`` as given: device names,
    ``torch.device`` objects, repeats allowed (``["cpu"] * 2``,
    ``["cuda:0", "cuda:0"]``). ``n_devices`` keeps the first entries.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def run_entries(devices: Sequence[torch.device], fn: Callable[[int], object]) -> list:
    """``[fn(i) for i in range(len(devices))]``, each call under its entry's
    CUDA device. Where the entries name two or more distinct cards, each
    card's entries run in a thread of their own (in entry order), so every
    card is given its work before any call waits on one; otherwise the
    calls run in entry order on this thread. (The kernels' launch counters
    are module globals bumped without a lock: with threads they are
    measurement aids, not exact.)"""

    def on_entry(i):
        if devices[i].type == "cuda":
            with torch.cuda.device(devices[i]):
                return fn(i)
        return fn(i)

    cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    if len(cards) < 2:
        return [on_entry(i) for i in range(len(devices))]

    out, errors = {}, []

    def card_entries(card):
        try:
            for i, d in enumerate(devices):
                if d == card:
                    out[i] = on_entry(i)
        except BaseException as e:  # re-raised on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=card_entries, args=(card,)) for card in cards]
    for t in threads:
        t.start()
    for i, d in enumerate(devices):
        if d.type != "cuda":
            out[i] = on_entry(i)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return [out[i] for i in range(len(devices))]


def psum(tensors: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The entries' tensors summed in entry order on the first entry's
    device, then copied to each entry (``lax.psum`` in one process)."""
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device, non_blocking=True)
    return [total.to(d, non_blocking=True) for d in devices]


def ppermute(values: Sequence[tuple], devices: Sequence[torch.device], shift: int = 1) -> list:
    """Entry ``i``'s tuple of tensors copied to entry ``(i + shift) % D``
    (``lax.ppermute`` around the ring)."""
    D = len(devices)
    out = [None] * D
    for i, x in enumerate(values):
        j = (i + shift) % D
        out[j] = tuple(t.to(devices[j], non_blocking=True) for t in x)
    return out


class Sharded:
    """A batch-major array placed on a mesh: one tensor a mesh entry, split
    along ``axis_name`` (the same part on every entry of the other axes), or
    the whole array on every entry when ``axis_name`` is None (replicated).
    ``np.asarray(x)`` gathers the global array to the host."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, axis_name: Optional[str]):
        self.shards = list(shards)  # in mesh.devices.flat order
        self.mesh = mesh
        self.axis_name = axis_name

    def parts(self) -> List[torch.Tensor]:
        """One tensor for each index along the sharded axis (one in all
        when replicated)."""
        if self.axis_name is None:
            return self.shards[:1]
        pos = self.mesh.axis_names.index(self.axis_name)
        first = {}
        for e, idx in enumerate(np.ndindex(self.mesh.devices.shape)):
            first.setdefault(idx[pos], self.shards[e])
        return [first[i] for i in range(self.mesh.shape[self.axis_name])]

    def gather(self) -> torch.Tensor:
        """The global array on the host."""
        parts = [p.cpu() for p in self.parts()]
        return parts[0] if self.axis_name is None else torch.cat(parts)

    def __array__(self, dtype=None, copy=None):
        out = self.gather().numpy()
        return out if dtype is None else out.astype(dtype)

    def __int__(self) -> int:
        return int(self.gather().item())


def _tensor(array) -> torch.Tensor:
    return array if isinstance(array, torch.Tensor) else torch.as_tensor(np.asarray(array))


def _place(parts: Sequence[torch.Tensor], mesh: Mesh, axis_name: Optional[str]) -> Sharded:
    pos = None if axis_name is None else mesh.axis_names.index(axis_name)
    shards = [
        parts[0 if pos is None else idx[pos]].to(mesh.devices[idx], non_blocking=True)
        for idx in np.ndindex(mesh.devices.shape)
    ]
    return Sharded(shards, mesh, axis_name)


def shard_batch(array, mesh: Mesh, axis_name: str = BATCH_AXIS, pad_to_multiple: bool = True):
    """Place a batch-major array on the mesh, batch axis sharded.

    Pads the batch (with zero rows — the zero syndrome decodes trivially) up
    to a multiple of the mesh size so the shard shapes are equal. Returns
    ``(sharded_array, original_batch_size)``.
    """
    arr = _tensor(array)
    B = arr.shape[0]
    size = mesh.shape[axis_name]
    if pad_to_multiple and B % size:
        pad = torch.zeros((size - B % size,) + tuple(arr.shape[1:]), dtype=arr.dtype)
        arr = torch.cat([arr, pad.to(arr.device)])
    return _place(torch.tensor_split(arr, size), mesh, axis_name), B


def replicate(array, mesh: Mesh) -> Sharded:
    """Replicate a (small) array — PCM layout, channel LLRs — on every entry."""
    return _place([_tensor(array)], mesh, None)


def unshard(array, batch_size: int) -> np.ndarray:
    """Gather a sharded batch result to the host and strip the padding rows."""
    if isinstance(array, torch.Tensor):
        array = array.cpu()
    return np.asarray(array)[:batch_size]


def psum_tally(values, mesh: Mesh, axis_name: str = BATCH_AXIS) -> Sharded:
    """Sum per-element tallies (fail counts, iteration counts) across the
    mesh — the distributed Monte-Carlo statistics reduction.

    ``values`` is a :class:`Sharded` batch (or an array, summed whole); the
    result is the sum, replicated on every entry: each part summed on its
    entry, the parts summed in entry order (:func:`psum`), and, after
    :func:`~ldpc_tpu_torch.parallel.distributed.initialize`, all-reduced
    over the processes.
    """
    from ldpc_tpu_torch.parallel.distributed import all_reduce

    if not isinstance(values, Sharded):
        values = _place([_tensor(values)], mesh, None)
    parts = values.parts()
    sums = [p.sum() for p in parts]
    total = psum(sums, [p.device for p in parts])[0]
    return _place([all_reduce(total)], mesh, None)
