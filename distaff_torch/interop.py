"""Field-element tensors to and from numpy.

Field elements are (..., 4) little-endian uint32 limb tensors: the same
bytes as the JAX package's limb arrays and as the u128 LE serialization,
so state crosses between the packages as numpy arrays unchanged.
"""

import numpy as np
import torch


def limbs_from_numpy(arr, device):
    """(..., 4) uint32 numpy limbs -> tensor on `device`.  A copy to the
    card is staged in pinned memory and queued on the current stream, so
    the host does not wait for the work queued before it."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.shape[-1:] != (4,):
        raise ValueError(f"expected (..., 4) limbs, got shape {arr.shape}")
    tensor = torch.from_numpy(arr)
    if torch.device(device).type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def limbs_to_numpy(tensor):
    """(..., 4) uint32 limb tensor -> numpy array on the host."""
    if tensor.dtype != torch.uint32 or tensor.shape[-1:] != (4,):
        raise ValueError(f"expected (..., 4) uint32 limbs, got {tensor.dtype} {tuple(tensor.shape)}")
    return tensor.detach().cpu().numpy()
