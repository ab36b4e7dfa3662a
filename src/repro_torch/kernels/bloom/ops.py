"""Public Bloom-filter API: geometry, build (a torch scatter plus a word
pack, once per table), the stacked filter operand, and the fused probe
(the CUDA kernel on the card, its twin on the CPU) — the port of
``repro/kernels/bloom/ops.py``.

Filter words live on the engine's device as int32 bit patterns of the
reference's uint32 words.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..keys import to_device
from .bloom import bloom_probe_multi_kernel, key_hashes


def filter_params(n_keys: int, fpr: float = 0.01) -> tuple[int, int]:
    """(n_bits, k_hashes) for a target false-positive rate (1% in the
    paper's setup, Section 3.1) — the reference's geometry exactly."""
    n_keys = max(n_keys, 1)
    n_bits = int(math.ceil(-n_keys * math.log(fpr) / (math.log(2) ** 2)))
    n_bits = max(128, (n_bits + 127) // 128 * 128)
    k = max(1, round(n_bits / n_keys * math.log(2)))
    return n_bits, min(k, 16)


def bloom_build(keys: torch.Tensor, n_bits: int,
                k_hashes: int) -> torch.Tensor:
    """The filter of int32 key bit patterns as (n_bits/32,) int32 words.

    OR-semantics via an idempotent index fill into a byte-per-bit array,
    one hash lane at a time (pos_i = (h1 + i*h2) mod n_bits, the uint32
    wrap before the mod), then a pack of 32 bits per word (n_bits is a
    multiple of 128).  Lane by lane keeps the peak at a few key-sized
    temporaries, where the (k, n) position matrix of the reference would
    take gigabytes for a table of tens of millions of keys."""
    h1, h2 = key_hashes(keys)
    bits = torch.zeros(n_bits, dtype=torch.uint8, device=keys.device)
    for i in range(k_hashes):
        bits.index_fill_(0, ((h1 + i * h2) & 0xFFFFFFFF) % n_bits, 1)
    bits = bits.view(-1, 32)
    words = torch.zeros(bits.shape[0], dtype=torch.int64,
                        device=keys.device)
    for j in range(32):
        words |= bits[:, j].to(torch.int64) << j
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def stack_filters(filters, n_bits_list, k_hashes_list,
                  device: "str | torch.device" = "cuda"):
    """Pad per-table filters to a common word count and pack their
    geometry: returns (filts (T, W) int32 on ``device``, meta (T, 2)
    uint32 on the host) ready for ``bloom_probe_multi``."""
    t = len(filters)
    w = max((int(f.shape[0]) for f in filters), default=1)
    filts = torch.zeros((t, max(w, 1)), dtype=torch.int32, device=device)
    meta = np.zeros((t, 2), np.uint32)
    for i, (f, nb, kh) in enumerate(zip(filters, n_bits_list,
                                        k_hashes_list)):
        filts[i, :f.shape[0]] = f
        meta[i] = (nb, kh)
    return filts, meta


def set_stack_row(filts: torch.Tensor, row_words: torch.Tensor,
                  slot: int) -> torch.Tensor:
    """Write one filter's words into row ``slot`` of a stacked filter
    tensor IN PLACE (zero-filling the row past the filter's width) — the
    engine's O(row) read-view maintenance step, one per flush or merge
    output.  Returns ``filts`` itself."""
    n = int(row_words.shape[0])
    filts[slot, :n] = row_words
    filts[slot, n:] = 0
    return filts


def bloom_probe_multi(filts: torch.Tensor, meta: np.ndarray,
                      keys) -> np.ndarray:
    """Probe one key batch (host uint32 or a device int32 tensor) against
    a stack of filters in one launch; returns the (tables, keys) bool
    maybe-present matrix on the host (no false negatives per table).

    The key batch is not padded to a block: the CUDA kernel masks its
    own ragged edge."""
    t = int(filts.shape[0])
    if not isinstance(keys, torch.Tensor):
        keys = to_device(np.asarray(keys, np.uint32), filts.device)
    n = int(keys.shape[0])
    if t == 0 or n == 0:
        return np.zeros((t, n), bool)
    out = bloom_probe_multi_kernel(filts, meta, keys.contiguous())
    return out.cpu().numpy().astype(bool)
