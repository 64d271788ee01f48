from ldpc_tpu_torch.helpers.scipy_helpers import convert_to_binary_sparse

__all__ = ["convert_to_binary_sparse"]
