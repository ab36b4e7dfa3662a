"""Immutable sorted-run component of the storage engine.

One SSTable corresponds to one scheduling-plane ``Component`` so the
paper's policies and schedulers drive real bytes.

Residency: the HOST mirrors (``keys_np``/``vals_np``, uint32/int32) are
the authoritative storage — point lookups ``np.searchsorted`` them and
range scans slice them, with no device sync per lookup.  The DEVICE
tensors (``keys``/``vals``, int32 bit patterns on the engine's device)
are what the merge and Bloom kernels read: a merge output adopts the
merge's device output (``dev=``) and is never re-uploaded; a flushed
memtable is uploaded once, when it is built (zero-copy on the CPU).
The Bloom filter is built lazily, on the first point read that needs
it — never on the flush/merge path, whose quanta must stay O(quantum).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.bloom.ops import bloom_build, filter_params
from ..kernels.keys import to_device
from .component import Component
from .iostack import data_crc32
from .memtable import scan_window, sorted_lookup


@dataclass
class SSTable:
    keys_np: np.ndarray                # (n,) uint32, sorted asc, unique
    vals_np: np.ndarray                # (n,) int32
    keys: torch.Tensor                 # (n,) int32 bit patterns, on device
    vals: torch.Tensor                 # (n,) int32, on device
    n_bits: int = 0
    k_hashes: int = 0
    component: Optional[Component] = None
    data_stamp: int = 0                # data age: strictly increasing at
                                       # flush; max over inputs at merge
    stack_slot: int = -1               # row in the engine's filter stack
    crc32: Optional[int] = None        # content checksum sealed at bind
    bloom: Optional[torch.Tensor] = None   # int32 words, built lazily

    @classmethod
    def build(cls, keys, vals, level: int = 0, created_at: float = 0.0,
              fpr: float = 0.01, device: "str | torch.device" = "cuda",
              dev: Optional[tuple] = None) -> "SSTable":
        """A table over host arrays ``keys``/``vals``; ``dev`` is the
        (keys, vals) pair already on ``device`` when a merge produced
        it, else the host arrays are uploaded."""
        keys_np = np.asarray(keys, np.uint32)
        vals_np = np.asarray(vals, np.int32)
        n = int(keys_np.shape[0])
        n_bits, k_hashes = filter_params(n, fpr)
        lo = float(keys_np[0]) / 2**32 if n else 0.0
        hi = (float(keys_np[-1]) + 1) / 2**32 if n else 1.0
        comp = Component(size=float(n), level=level, key_lo=lo, key_hi=hi,
                         created_at=created_at)
        if dev is None:
            dev = (to_device(keys_np, device), to_device(vals_np, device))
        return cls(keys_np=keys_np, vals_np=vals_np, keys=dev[0],
                   vals=dev[1], n_bits=n_bits, k_hashes=k_hashes,
                   component=comp)

    def __len__(self) -> int:
        return int(self.keys_np.shape[0])

    # -- integrity ------------------------------------------------------------
    def seal_checksum(self) -> int:
        """Seal the content CRC when the table binds into a read view
        (flush, merge completion)."""
        self.crc32 = int(data_crc32(self.keys_np, self.vals_np))
        return self.crc32

    def ensure_bloom(self) -> torch.Tensor:
        """The filter words on the table's device, built on first use."""
        if self.bloom is None:
            self.bloom = bloom_build(self.keys, self.n_bits, self.k_hashes)
        return self.bloom

    # -- queries --------------------------------------------------------------
    def search(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Sorted-search lookup WITHOUT the bloom screen: (found mask,
        values).  The engine calls this only for keys the fused probe
        said may be present."""
        keys = np.asarray(keys, np.uint32)
        if len(self) == 0 or len(keys) == 0:
            return np.zeros(len(keys), bool), np.zeros(len(keys), np.int32)
        return sorted_lookup(self.keys_np, self.vals_np, keys)

    def scan_range(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """All (key, value) with lo <= key < hi: a zero-copy window of
        the host mirrors (the per-table input of the engine's k-way range
        merge)."""
        return scan_window(self.keys_np, self.vals_np, lo, hi)
