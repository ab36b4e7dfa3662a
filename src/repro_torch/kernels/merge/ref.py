"""Numpy oracles for the merge kernels (independent of the merge-path
plan, the padding and the tournament)."""
from __future__ import annotations

import numpy as np


def merge_sorted_age_ref(keys_a, vals_a, age_a, keys_b, vals_b, age_b):
    """Stable two-run merge ordered by (uint32 key, age).  Returns
    (keys, vals, ages)."""
    keys = np.concatenate([keys_a, keys_b]).astype(np.uint32)
    vals = np.concatenate([vals_a, vals_b]).astype(np.int32)
    ages = np.concatenate([age_a, age_b]).astype(np.int32)
    order = np.lexsort((ages, keys))
    return keys[order], vals[order], ages[order]


def merge_dedup_kway_ref(runs):
    """Oracle for the k-way tournament (runs NEWEST first): replay the
    runs oldest -> newest into a dict so later (newer) writes win."""
    d = {}
    for ks, vs in reversed(list(runs)):
        for k, v in zip(np.asarray(ks), np.asarray(vs)):
            d[int(k)] = int(v)
    items = sorted(d.items())
    ks = np.array([k for k, _ in items], np.uint32)
    vs = np.array([v for _, v in items], np.int32)
    return ks, vs
