"""Where the port's tensors live: the CUDA device unless the caller asks
for the CPU."""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, checked once.

    A CUDA device that this process does not have raises here, with what
    to pass instead, rather than later inside torch or by running on the
    CPU unasked.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ldpc_tpu_torch runs on a CUDA device by default and device={str(dev)!r} "
            "is not available here; pass device=\"cpu\" to run the kernels' plain "
            "PyTorch versions on the CPU"
        )
    return dev
