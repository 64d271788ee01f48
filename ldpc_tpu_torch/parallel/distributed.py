"""Multi-process initialisation (port of ``ldpc_tpu.parallel.distributed``).

JAX's multi-host execution is one SPMD program per host process over a
global device set, set up by ``jax.distributed.initialize``. The port keeps
the same two levels: within a process, a :class:`~ldpc_tpu_torch.parallel.
sharding.Mesh` of that process's devices; across processes, a
``torch.distributed`` process group that :func:`initialize` sets up, with
NCCL on CUDA and gloo on the CPU. After it, the sharded steps (and
``psum_tally``) add one :func:`all_reduce` over the processes on top of
their in-process sum, and a mesh entry's global index is
``process_index() * local entries + its local index``.

The rendezvous reads the same environment variables as the JAX package:
``LDPC_TPU_COORDINATOR`` (``host:port``, or an ``init_method`` URL),
``LDPC_TPU_NUM_PROCESSES`` and ``LDPC_TPU_PROCESS_ID``; explicit arguments
win. With neither, :func:`initialize` does nothing and returns 0. NCCL does
not take two ranks on one card, so processes that share a card use gloo
(``device="cpu"``).
"""

import datetime
import os
from typing import Optional

import torch

from ldpc_tpu_torch.device import resolve_device

_ENV_COORD = "LDPC_TPU_COORDINATOR"
_ENV_NPROC = "LDPC_TPU_NUM_PROCESSES"
_ENV_PID = "LDPC_TPU_PROCESS_ID"

_initialized = False


def is_distributed() -> bool:
    """True once :func:`initialize` has set up a process group."""
    return _initialized


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    timeout: float = 300.0,
) -> int:
    """Idempotently join the process group; returns this process's index.

    Each parameter comes from its argument, else its ``LDPC_TPU_*``
    environment variable. With no coordinator and no process count this is
    a no-op returning 0. ``device`` picks the backend: NCCL on a CUDA device
    (which becomes this process's current card: the given index, else
    ``process_id`` modulo the cards visible), gloo on the CPU. ``timeout``
    (seconds) bounds the rendezvous and every collective, so a broken
    rendezvous fails rather than hangs.
    """
    global _initialized
    import torch.distributed as dist

    if _initialized:
        return dist.get_rank()
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes is None:
        return 0
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs the coordinator's address, the number of "
            f"processes and this process's id ({_ENV_COORD}, {_ENV_NPROC}, {_ENV_PID})"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(
            dev.index if dev.index is not None else process_id % torch.cuda.device_count()
        )
    init_method = (
        coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    )
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout),
    )
    _initialized = True
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group (a no-op unless :func:`initialize` joined one)."""
    global _initialized
    if _initialized:
        import torch.distributed as dist

        dist.destroy_process_group()
        _initialized = False


def process_index() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def process_count() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def local_device_count() -> int:
    """The cards this process can place mesh entries on, or 1 (the CPU)
    without one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_device_count() -> int:
    """Every process's :func:`local_device_count`, summed (each process is
    taken to see as many devices as this one)."""
    return local_device_count() * process_count()


def all_reduce(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the processes (itself outside a process
    group). gloo reduces on the host, so a CUDA tensor goes through a host
    copy there."""
    if not _initialized:
        return tensor
    import torch.distributed as dist

    if dist.get_backend() == "gloo" and tensor.device.type != "cpu":
        host = tensor.cpu()
        dist.all_reduce(host)
        return host.to(tensor.device)
    out = tensor.clone()
    dist.all_reduce(out)
    return out
