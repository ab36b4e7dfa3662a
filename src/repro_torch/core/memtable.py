"""In-memory LSM component (memtable) for the real engine.

Writes append to unsorted numpy buffers (O(1) per put, like a skiplist's
amortized role here); sealing sorts once and deduplicates newest-wins,
producing the sorted run a flush turns into an SSTable.  Keys are uint32
(key == 2**32-1 is reserved as the merge kernel's sentinel), values are
int32 payload handles.

Deletes are TOMBSTONES: an entry whose value is the reserved
``TOMBSTONE`` sentinel (int32 min, rejected on the user put path) is a
delete marker.  It flows through seal/flush/merge as ordinary data —
newest-wins dedup resolves put-vs-delete races for free — and only the
READ plane (engine get/scan) and the bottom-level merge drop it.  The
memtable itself is tombstone-agnostic: ``get``/``get_batch``/
``scan_range`` return tombstoned entries like any other so the engine's
newest-first resolution can distinguish "deleted here" (stop searching
older runs) from "not present" (keep searching).
"""
from __future__ import annotations

import numpy as np

SENTINEL_KEY = np.uint32(0xFFFFFFFF)
TOMBSTONE = np.int32(-2**31)       # reserved value: a delete marker


def drop_tombstones(keys: np.ndarray,
                    vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Filter delete markers out of a merged run — the read plane's last
    step (scans) and the bottom-level merge's reclamation step share it."""
    live = vals != TOMBSTONE
    if live.all():
        return keys, vals
    return keys[live], vals[live]


def sorted_lookup(sk: np.ndarray, sv: np.ndarray,
                  keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(found mask, values) for ``keys`` against a sorted unique run
    ``(sk, sv)`` — the one sorted-search used by memtables and SSTables."""
    if len(sk) == 0 or len(keys) == 0:
        return np.zeros(len(keys), bool), np.zeros(len(keys), np.int32)
    pos = np.minimum(np.searchsorted(sk, keys), len(sk) - 1)
    found = sk[pos] == keys
    return found, np.where(found, sv[pos], 0).astype(np.int32)


def scan_window(sk: np.ndarray, sv: np.ndarray, lo: int,
                hi: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``[lo, hi)`` window of a sorted unique run — the one
    ``searchsorted`` slice used by memtables and SSTables on the range
    plane.  Bounds are clamped to the uint32 key space: the sentinel
    2**32-1 is never stored, so a clamped ``hi`` of 2**32 loses
    nothing."""
    i = int(np.searchsorted(sk, np.uint32(min(max(lo, 0), 0xFFFFFFFF))))
    j = int(np.searchsorted(sk, np.uint32(min(max(hi, 0), 0xFFFFFFFF))))
    return sk[i:j], sv[i:j]


class MemTable:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._keys = np.empty(self.capacity, np.uint32)
        self._vals = np.empty(self.capacity, np.int32)
        self._n = 0
        self.start_lsn = 0             # WAL LSN of this memtable's first
                                       # entry (set by the engine; the
                                       # oldest unflushed memtable's
                                       # start_lsn is the replay origin)
        # sorted newest-wins view, cached between writes (sealed
        # memtables are immutable, so theirs is computed exactly once)
        self._sealed: tuple[np.ndarray, np.ndarray] | None = None

    def __len__(self) -> int:
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def put(self, key: int, value: int) -> None:
        if self._n >= self.capacity:
            raise RuntimeError("memtable full; seal it first")
        k = np.uint32(key)
        if k == SENTINEL_KEY:
            raise ValueError("key 2**32-1 is reserved")
        self._keys[self._n] = k
        self._vals[self._n] = np.int32(value)
        self._n += 1
        self._sealed = None

    def put_batch(self, keys, values) -> int:
        """Admit the longest prefix that fits; returns the count admitted
        (0 when full — never raises on overflow, so bulk admission needs
        no try/except on the hot path).  A reserved sentinel key anywhere
        in the batch is rejected ATOMICALLY (ValueError before any entry
        is admitted) — unlike the scalar ``put`` loop, which would admit
        the prefix before raising; batch callers get all-or-nothing
        validation instead."""
        keys = np.asarray(keys, np.uint32)
        values = np.asarray(values, np.int32)
        if (keys == SENTINEL_KEY).any():
            raise ValueError("key 2**32-1 is reserved")
        take = min(len(keys), self.capacity - self._n)
        if take > 0:
            self._keys[self._n:self._n + take] = keys[:take]
            self._vals[self._n:self._n + take] = values[:take]
            self._n += take
            self._sealed = None
        return take

    def get(self, key: int):
        """Newest-wins lookup over the unsorted tail (scan newest-first)."""
        k = np.uint32(key)
        idx = np.flatnonzero(self._keys[:self._n] == k)
        if idx.size:
            return int(self._vals[idx[-1]])
        return None

    def get_batch(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized newest-wins lookup: (found mask, values) for a key
        batch.  Small batches against a write-dirtied buffer use the
        O(n)-per-key linear scan (the scalar hot path under interleaved
        put/get); larger batches amortize one sort via the cached sealed
        view."""
        keys = np.asarray(keys, np.uint32)
        q = len(keys)
        if self._n == 0 or q == 0:
            return np.zeros(q, bool), np.zeros(q, np.int32)
        if self._sealed is None and q < 16:
            found = np.zeros(q, bool)
            vals = np.zeros(q, np.int32)
            buf_k = self._keys[:self._n]
            buf_v = self._vals[:self._n]
            for i in range(q):
                idx = np.flatnonzero(buf_k == keys[i])
                if idx.size:
                    found[i] = True
                    vals[i] = buf_v[idx[-1]]      # last write wins
            return found, vals
        sk, sv = self.seal()
        return sorted_lookup(sk, sv, keys)

    def scan_range(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """All (key, value) with lo <= key < hi, sorted newest-wins —
        a ``scan_window`` over the cached sealed view, so a memtable
        enters the engine's k-way range merge as one sorted run exactly
        like an SSTable."""
        sk, sv = self.seal()
        return scan_window(sk, sv, lo, hi)

    def seal(self):
        """Sorted, newest-wins-deduplicated (keys, values) arrays
        (cached until the next write)."""
        if self._sealed is None:
            keys = self._keys[:self._n]
            vals = self._vals[:self._n]
            # stable sort keeps insertion order within equal keys; keep
            # the last
            order = np.argsort(keys, kind="stable")
            sk, sv = keys[order], vals[order]
            last = np.ones(len(sk), bool)
            if len(sk) > 1:
                last[:-1] = sk[1:] != sk[:-1]
            self._sealed = (sk[last], sv[last])
        return self._sealed
