"""The age-carrying merge-path merge: the CUDA kernel
(``csrc/merge_path.cu``), its wrapper, and its plain PyTorch twin.

It replaces ``repro/kernels/merge/merge.py::merge_path_merge_age``.
Runs A and B hold int32 key bit patterns (ordered as uint32), int32
values and int32 ages (original run indices, smaller = newer, every age
in A smaller than every age in B), each with a sentinel tail of at least
one block; ``parts`` (g+1, 2) int32 is the co-rank table of
``ops.merge_partitions``.  Output block b is entries
[b*block, (b+1)*block) of the merge ordered by (key, age): keys, values
and ages of length g*block, sentinels past the real entries.

The twin repeats the kernel's arithmetic — per output block, the two
block-long windows from its co-rank and a merge-path binary search per
output element — vectorised over all blocks at once.
"""
from __future__ import annotations

import torch

from ..cuda import I32, I64, P, CudaKernel, check_cuda
from ..keys import as_u64

MERGE = CudaKernel("merge_path.cu", "merge_path_merge_age",
                   (P, P, P, P, P, P, P, I64, I32, P, P, P, P))


def merge_path_merge_age_plain(keys_a, vals_a, age_a, keys_b, vals_b, age_b,
                               parts: torch.Tensor, block: int):
    """The twin: (keys, vals, ages) of length g*block, on the operands'
    device, bit-identical to the kernel."""
    g = int(parts.shape[0]) - 1
    dev = keys_a.device
    w = torch.arange(block, dtype=torch.int64, device=dev)[None, :]
    ia = parts[:g, 0].to(torch.int64)[:, None] + w              # (g, block)
    ib = parts[:g, 1].to(torch.int64)[:, None] + w
    # (key, age) as one int64: key < 2**32 and 0 <= age < 2**31
    ca = (as_u64(keys_a)[ia] << 31) | age_a.to(torch.int64)[ia]
    cb = (as_u64(keys_b)[ib] << 31) | age_b.to(torch.int64)[ib]
    d = w.expand(g, block)
    lo = torch.zeros_like(d)
    hi = d.clone()
    for _ in range(max(block, 1).bit_length()):
        live = lo < hi
        mid = (lo + hi) >> 1
        jb = (d - 1 - mid).clamp(min=0)
        a_first = torch.gather(ca, 1, mid.clamp(max=block - 1)) <= \
            torch.gather(cb, 1, jb)
        lo = torch.where(live & a_first, mid + 1, lo)
        hi = torch.where(live & ~a_first, mid, hi)
    i, j = lo, d - lo
    take_a = torch.gather(ca, 1, i) <= torch.gather(cb, 1, j)
    src_a = torch.gather(ia, 1, i)
    src_b = torch.gather(ib, 1, j)
    out = []
    for xa, xb in ((keys_a, keys_b), (vals_a, vals_b), (age_a, age_b)):
        out.append(torch.where(take_a, xa[src_a], xb[src_b]).reshape(-1))
    return tuple(out)


def merge_path_merge_age_cuda(keys_a, vals_a, age_a, keys_b, vals_b, age_b,
                              parts: torch.Tensor, block: int):
    """Launch the CUDA merge on contiguous int32 CUDA tensors; returns
    (keys, vals, ages) of length g*block on the card."""
    names = ("keys_a", "vals_a", "age_a", "keys_b", "vals_b", "age_b")
    ops = (keys_a, vals_a, age_a, keys_b, vals_b, age_b)
    for name, t in zip(names, ops):
        check_cuda(f"merge_path_merge_age {name}", t, torch.int32, 1)
    check_cuda("merge_path_merge_age parts", parts, torch.int32, 2)
    if not 1 <= block <= 1024:
        raise ValueError(f"block must be in [1, 1024], got {block}")
    n_a, n_b = int(keys_a.shape[0]), int(keys_b.shape[0])
    if vals_a.shape[0] != n_a or age_a.shape[0] != n_a or \
            vals_b.shape[0] != n_b or age_b.shape[0] != n_b:
        raise ValueError("keys, values and ages of a run differ in length")
    if parts.shape[1] != 2 or min(n_a, n_b) < block:
        raise ValueError("parts must be (g+1, 2) and each run must carry a "
                         "sentinel tail of at least one block")
    g = int(parts.shape[0]) - 1
    if g * block > n_a + n_b - 2 * block:
        raise ValueError("the output is longer than the runs' real entries")
    dev = keys_a.device
    ko = torch.empty(g * block, dtype=torch.int32, device=dev)
    vo = torch.empty_like(ko)
    ao = torch.empty_like(ko)
    if g:
        MERGE.launch(*(t.data_ptr() for t in ops), parts.data_ptr(), g,
                     block, ko.data_ptr(), vo.data_ptr(), ao.data_ptr())
    return ko, vo, ao


def merge_path_merge_age(keys_a, vals_a, age_a, keys_b, vals_b, age_b,
                         parts: torch.Tensor, block: int = 256):
    """The merge on the operands' device: the CUDA kernel for CUDA
    tensors, the twin for CPU tensors."""
    fn = merge_path_merge_age_cuda if keys_a.is_cuda else \
        merge_path_merge_age_plain
    return fn(keys_a, vals_a, age_a, keys_b, vals_b, age_b, parts, block)
