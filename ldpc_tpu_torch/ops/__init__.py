"""Device-side compute for batched decoding (PyTorch + hand-written CUDA)."""

from ldpc_tpu_torch.ops.pcm import TorchGraph, graph_to_torch

__all__ = ["TorchGraph", "graph_to_torch"]
