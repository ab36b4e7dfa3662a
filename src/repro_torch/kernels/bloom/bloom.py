"""The fused multi-table Bloom probe: the CUDA kernel
(``csrc/bloom_probe.cu``), its wrapper, and its plain PyTorch twin.

It replaces ``repro/kernels/bloom/bloom.py::bloom_probe_multi_kernel``.
Filter words and keys are int32 bit patterns of the reference's uint32
arrays; ``meta`` is the host-side (tables, 2) uint32 geometry.  The twin
does the hash in int64 masked to 32 bits (torch's uint32 supports few
ops); the kernel does it in native ``uint32_t``.  Both give the same
(tables, keys) uint8 matrix, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cuda import I32, I64, P, CudaKernel, check_cuda
from ..keys import U32_MASK, as_u64

SEED1 = 0x9E3779B9
SEED2 = 0x85EBCA6B
MULT = 0x45D9F3B

#: the shared memory a block may take for a staged filter row (H100: 227 KB)
SMEM_LIMIT_BYTES = 232_448
THREADS = 1024

PROBE = CudaKernel("bloom_probe.cu", "bloom_probe_multi",
                   (P, I64, I64, P, P, I64, I32, I32, I32, P, P))


def hash_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """xorshift-multiply finalizer on uint32 values held in int64 (every
    product stays below 2**59, so masking to 32 bits is exact)."""
    x = x ^ seed
    x = ((x ^ (x >> 16)) * MULT) & U32_MASK
    x = ((x ^ (x >> 16)) * MULT) & U32_MASK
    return x ^ (x >> 16)


def key_hashes(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h1, h2) of int32 key bit patterns, as int64 uint32 values."""
    k = as_u64(keys)
    return hash_u32(k, SEED1), hash_u32(k, SEED2) | 1


def bloom_probe_multi_plain(filts: torch.Tensor, meta: np.ndarray,
                            keys: torch.Tensor) -> torch.Tensor:
    """The twin: (tables, keys) uint8 maybe-present flags, on the
    operands' device.  Lanes past a row's own k pass; the sum
    ``h1 + i*h2`` wraps at 2**32 before the mod, as in uint32."""
    t, n = int(filts.shape[0]), int(keys.shape[0])
    dev = filts.device
    meta = np.asarray(meta, np.uint32)
    out = torch.ones((t, n), dtype=torch.bool, device=dev)
    if t == 0 or n == 0:
        return out.to(torch.uint8)
    h1, h2 = key_hashes(keys)
    n_bits = torch.as_tensor(meta[:, 0].astype(np.int64), device=dev)[:, None]
    k = torch.as_tensor(meta[:, 1].astype(np.int64), device=dev)[:, None]
    words = filts.to(torch.int64) & U32_MASK
    for i in range(int(meta[:, 1].max())):
        pos = ((h1 + i * h2) & U32_MASK)[None, :] % n_bits       # (t, n)
        w = torch.gather(words, 1, pos >> 5)
        bit = ((w >> (pos & 31)) & 1).to(torch.bool)
        out &= bit | (i >= k)
    return out.to(torch.uint8)


def _launch_geometry(meta: np.ndarray, n_keys: int) -> tuple[int, int]:
    """(smem_words, chunks) of a launch: shared memory for the widest row
    that fits, and enough key chunks per table for about two waves of
    blocks on 132 SMs while each block keeps at least 1,024 keys."""
    row_words = (meta[:, 0].astype(np.int64) + 31) // 32
    fits = row_words[row_words * 4 <= SMEM_LIMIT_BYTES]
    smem_words = int(fits.max()) if fits.size else 0
    t = int(meta.shape[0])
    chunks = max(1, min(-(-n_keys // 1024), -(-264 // t)))
    return smem_words, chunks


def bloom_probe_multi_cuda(filts: torch.Tensor, meta: np.ndarray,
                           keys: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA probe: ``filts`` (tables, words) and ``keys``
    (n,) int32 on the card, ``meta`` the host (tables, 2) uint32
    geometry.  Returns (tables, n) uint8 on the card."""
    check_cuda("bloom_probe_multi filts", filts, torch.int32, 2)
    check_cuda("bloom_probe_multi keys", keys, torch.int32, 1)
    meta = np.ascontiguousarray(meta, np.uint32)
    t, w = int(filts.shape[0]), int(filts.shape[1])
    n = int(keys.shape[0])
    if meta.shape != (t, 2):
        raise ValueError(f"meta must be ({t}, 2), got {meta.shape}")
    if t > 65535:
        raise ValueError(f"{t} tables exceed the launch grid's 65,535 rows")
    if t and ((meta[:, 0] == 0).any() or (meta[:, 1] == 0).any()
              or int(meta[:, 0].max()) > 32 * w):
        raise ValueError("meta rows need 0 < n_bits <= 32*width and k > 0")
    out = torch.empty((t, n), dtype=torch.uint8, device=filts.device)
    if t == 0 or n == 0:
        return out
    meta_dev = torch.from_numpy(meta.view(np.int32)).to(filts.device)
    smem_words, chunks = _launch_geometry(meta, n)
    PROBE.launch(filts.data_ptr(), t, w, meta_dev.data_ptr(),
                 keys.data_ptr(), n, smem_words, chunks, THREADS,
                 out.data_ptr())
    return out


def bloom_probe_multi_kernel(filts: torch.Tensor, meta: np.ndarray,
                             keys: torch.Tensor) -> torch.Tensor:
    """The probe on the operands' device: the CUDA kernel for CUDA
    tensors, the twin for CPU tensors."""
    if filts.is_cuda:
        return bloom_probe_multi_cuda(filts, meta, keys)
    return bloom_probe_multi_plain(filts, meta, keys)
