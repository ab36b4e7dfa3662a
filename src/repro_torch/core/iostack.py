"""The part of the reference's fault-tolerant I/O layer that the storage
engine needs before the durability plane is ported: the run checksum
sealed when a table binds, and the two typed errors of the write and
read paths.  The ``IOStack`` itself (retry, backoff, injected faults)
belongs to the durability slice.
"""
from __future__ import annotations

import zlib

import numpy as np


class StorageFull(OSError):
    """ENOSPC: the write path converts this into a constraint-style
    stall (writes drain when space returns) instead of crashing."""

    def __init__(self, point: str):
        super().__init__(f"no space left on device (at {point!r})")
        self.point = point


class CorruptionError(RuntimeError):
    """A checksum mismatch on durable data (snapshot file or live
    table)."""


class UnrepairableCorruptionError(CorruptionError):
    """Corruption with no surviving durable copy to rebuild from:
    reads of the affected tree raise this rather than answer wrong."""


def data_crc32(keys: np.ndarray, vals: np.ndarray) -> int:
    """The one checksum formula for a sorted run's content: CRC32 over
    the key bytes then the value bytes (little-endian mirrors), equal to
    the reference package's, so a run holds the same checksum in both."""
    crc = zlib.crc32(np.ascontiguousarray(keys, np.uint32).tobytes())
    return zlib.crc32(np.ascontiguousarray(vals, np.int32).tobytes(), crc)
