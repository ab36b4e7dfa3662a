"""uint32 keys on torch tensors.

Keys are uint32 and torch's ``uint32`` supports few operations, so the
port carries them as int32 BIT PATTERNS (the same 4 bytes).  Equality is
the same either way; every ordering (sort, compare, searchsorted) must
be unsigned, so ordering code widens to int64 with ``as_u64`` first —
keys >= 2**31 would otherwise sort negative.
"""
from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF
SENTINEL = -1                     # key 0xFFFFFFFF as an int32 bit pattern


def as_u64(keys: torch.Tensor) -> torch.Tensor:
    """The unsigned value of int32 key bit patterns, as int64."""
    return keys.to(torch.int64) & U32_MASK


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host uint32 key array (or int32 values) as an int32 tensor on
    ``device`` (zero-copy on the CPU)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.astype(np.int32, copy=False)).to(device)


def keys_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int32 key bit patterns back to a host uint32 array."""
    return keys.cpu().numpy().view(np.uint32)
