"""Public API of the sorted-merge kernel: co-rank planning, sentinel
padding, the pairwise age merge, and the k-way newest-wins tournament
(``merge_dedup_kway``) with its streaming-window variant — the port of
``repro/kernels/merge/ops.py``.

Runs are (keys, values) pairs of 1-d int32 tensors on one device, keys
holding uint32 bit patterns; every ordering here is unsigned.  The merge
step runs on the operands' device: the CUDA kernel on the card, its twin
on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..keys import SENTINEL, as_u64
from .merge import merge_path_merge_age

AGE_PAD = 2**31 - 1                  # sentinel tail age (oldest possible)


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def merge_partitions(keys_a: torch.Tensor, keys_b: torch.Tensor, n_a: int,
                     n_b: int, block: int) -> torch.Tensor:
    """Exact merge-path co-rank (i, j) of each output-block diagonal
    d = k*block, as a (g+1, 2) int32 tensor.

    With equal keys going to run A (the newer), A[p] lands at merged
    position ``p + searchsorted(B, A[p], 'left')``; these positions are
    strictly increasing, so the co-rank at diagonal d is
    ``i(d) = searchsorted(pos_A, d)`` and j(d) = d - i(d).  Keys widen to
    int64 first so that keys >= 2**31 order as unsigned."""
    dev = keys_a.device
    g = _ceil_to(n_a + n_b, block) // block
    diags = torch.clamp(torch.arange(g + 1, dtype=torch.int64, device=dev)
                        * block, max=n_a + n_b)
    ka = as_u64(keys_a[:n_a])
    kb = as_u64(keys_b[:n_b])
    pos_a = torch.arange(n_a, dtype=torch.int64, device=dev) + \
        torch.searchsorted(kb, ka, side="left")
    i = torch.searchsorted(pos_a, diags, side="left")
    return torch.stack([i, diags - i], dim=1).to(torch.int32)


def _pad_run_age(keys, vals, ages, block: int):
    """Append the sentinel tail (key 0xFFFFFFFF, value 0, age INT32_MAX)
    up to the block grid plus at least one whole block, so every
    block-long window the merge loads from a co-rank stays in bounds."""
    n = int(keys.shape[0])
    pad = _ceil_to(n, block) - n + block
    dev = keys.device
    return (torch.cat([keys, torch.full((pad,), SENTINEL, dtype=torch.int32,
                                        device=dev)]),
            torch.cat([vals, torch.zeros(pad, dtype=torch.int32,
                                         device=dev)]),
            torch.cat([ages, torch.full((pad,), AGE_PAD, dtype=torch.int32,
                                        device=dev)]))


def merge_sorted_age(keys_a, vals_a, age_a, keys_b, vals_b, age_b,
                     block: int = 256):
    """One tournament step: merge two (key, age)-sorted runs whose age
    sets are disjoint with every A-age < every B-age.  Returns
    (keys, vals, ages, valid_len) with sentinel padding past valid_len."""
    n_a, n_b = int(keys_a.shape[0]), int(keys_b.shape[0])
    ka, va, aa = _pad_run_age(keys_a, vals_a, age_a, block)
    kb, vb, ab = _pad_run_age(keys_b, vals_b, age_b, block)
    parts = merge_partitions(ka, kb, n_a, n_b, block)
    mk, mv, ma = merge_path_merge_age(ka, va, aa, kb, vb, ab, parts, block)
    return mk, mv, ma, n_a + n_b


def merge_dedup_kway_window(runs, starts, stops, block: int = 256,
                            drop_value: Optional[int] = None):
    """Streaming-quantum variant of ``merge_dedup_kway``: merge only the
    ``[starts[i], stops[i])`` window of each run.

    The engine cuts windows at a GLOBAL key boundary (no equal-key group
    straddles a cut), so per-window newest-wins dedup composes exactly:
    concatenated windows equal ``merge_dedup_kway`` over the full runs.
    An empty window keeps its position's age rank, so tie-breaking is
    unchanged."""
    windows = [(k[s:e], v[s:e])
               for (k, v), s, e in zip(runs, starts, stops)]
    return merge_dedup_kway(windows, block=block, drop_value=drop_value)


def merge_dedup_kway(runs, block: int = 256,
                     drop_value: Optional[int] = None):
    """K-way newest-wins merge of sorted unique runs (NEWEST run first).

    A balanced tournament over the age-carrying pairwise merge: each
    entry is tagged with its run index as its age (smaller = newer),
    adjacent pairs merge per round (the left run is newer, so every
    A-age < every B-age and the tie rule stays exact), and duplicates
    survive until ONE final pass keeps only the first entry of each
    equal-key group.  ``drop_value`` drops a whole group whose newest
    version carries that value (tombstone reclamation).

    Returns compacted (keys, vals) int32 tensors, sorted by unsigned key,
    on the runs' device."""
    dev = runs[0][0].device if runs else torch.device("cpu")
    entries = []
    for i, (k, v) in enumerate(runs):
        n = int(k.shape[0])
        if n:
            entries.append((k, v, torch.full((n,), i, dtype=torch.int32,
                                             device=dev), n))
    if not entries:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    while len(entries) > 1:
        nxt = []
        for j in range(0, len(entries) - 1, 2):
            ka, va, aa, na = entries[j]
            kb, vb, ab, nb = entries[j + 1]
            nxt.append(merge_sorted_age(ka[:na], va[:na], aa[:na], kb[:nb],
                                        vb[:nb], ab[:nb], block=block))
        if len(entries) % 2:
            nxt.append(entries[-1])
        entries = nxt
    keys, vals, _, valid = entries[0]
    keys, vals = keys[:valid], vals[:valid]
    # runs are (key, age)-sorted: the first of each group is the newest
    first = torch.ones(valid, dtype=torch.bool, device=dev)
    first[1:] = keys[1:] != keys[:-1]
    if drop_value is not None:
        first &= vals != int(drop_value)
    return keys[first], vals[first]
