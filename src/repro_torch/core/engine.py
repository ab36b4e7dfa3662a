"""The storage engine: a ``StorageGroup`` of ``LSMTree``s sharing one
I/O plane, with ``LSMEngine`` as the 1-tree instantiation — the port of
``repro/core/engine.py``'s write, read and merge path.

Ownership split
===============

``LSMTree`` owns everything whose state is a single LSM tree: the
memtable plane (``active``/``sealed``), the run levels
(``tables``/``_order``) and the scheduling-plane metadata (``meta``) the
merge POLICY reads, the cached read view and its Bloom filter stack, the
merge policy, scheduler and write constraint, the streaming cursors of
its running merges, and its stats and flush-quantum debt.

``StorageGroup`` owns the cross-cutting state once: the ``ExecBackend``
(the engine's device and its kernels), the I/O budget (each
``pump(budget)`` epoch splits the budget across trees by background debt
with ``apportion_largest_remainder``), the reentrant lock and the
virtual clock ``now``.

Not in this module yet: the WAL, fault injection, secondary indexes,
recovery, snapshots and the scrub pass.  ``wal=``, ``faults=`` and
``indexes=`` raise ``NotImplementedError``, as does ``enable_scrub``.

Execution model
===============

Deterministic cooperative quanta: flushes take strict priority, then
merges per the tree scheduler's allocation.  A merge is STREAMED so one
quantum costs O(quantum): it keeps per-run cursors, cuts each window at a
global key boundary (no equal-key group straddles windows, so the
concatenated windows equal the one-shot merge bit for bit), merges the
window on the device through the k-way tournament of merge-path kernel
launches, and writes the output into preallocated host buffers (the
authoritative mirrors) and a preallocated device tensor (slice copies).
``_finish_merge`` binds both as views.  A flush larger than the
remaining quantum carries its overshoot as debt repaid before new work.

Read view: point reads and scans go through a cached ``_ReadView`` of
the disk tables, NEWEST-FIRST by ``(-data_stamp, level)``, maintained
incrementally (a flush prepends one table, a merge completion
bisect-inserts its outputs).  The Bloom stack (``_FilterStack``) is
event-driven: background events journal adds and removes in O(1) and
the first point lookup after an event applies the journal (in-place
row writes on the device).  ``get_batch`` walks the view newest-first
with early exit behind ONE fused multi-table probe; ``scan_range``
resolves every run's window in one k-way newest-wins merge with
tombstones dropped in the merge.

Tombstones: deletes admit the reserved ``TOMBSTONE`` value through the
ordinary write path; the read plane hides it; a merge that no older run
overlaps drops it.

Thread safety: every foreground entry point and the background plane
take the group's reentrant lock; ``lock()`` exposes it.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..kernels.bloom.ops import set_stack_row
from .backend import ExecBackend
from .component import Component, MergeOp
from .component import LSMTree as ComponentTree
from .constraints import ComponentConstraint, NoConstraint
from .memtable import MemTable, SENTINEL_KEY, TOMBSTONE, drop_tombstones
from .policies import MergePolicy
from .scheduler import MergeScheduler, apportion_largest_remainder
from .sstable import SSTable

ENTRY_BYTES = 1024  # paper's 1 KB records: 1 entry == 1 KB of I/O budget

#: the slices that will bring what this module leaves out
_LATER = {"wal": "durability and faults (WAL, snapshots, recovery, scrub)",
          "faults": "durability and faults (WAL, snapshots, recovery, "
                    "scrub)",
          "indexes": "secondary indexes (StorageGroup with sibling trees)"}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the later slice '{_LATER[what]}'")


@dataclass
class _ReadView:
    """Cached snapshot of ONE tree's disk tables for the read plane.

    ``tables`` is newest-first by ``(-data_stamp, level)``.  ``filts``/
    ``meta`` stay ``None`` until the first point lookup applies the
    ``_FilterStack`` journal: ``filts`` is the stack's device tensor
    (capacity rows), ``meta`` its host-side per-row (n_bits, k); each
    table's probe row is its own ``stack_slot``."""
    tables: tuple
    filts: Optional[torch.Tensor] = None
    meta: Optional[np.ndarray] = None


class _FilterStack:
    """Persistent device Bloom filter stack with slot reuse — the fused
    probe's operand, maintained incrementally and EVENT-DRIVEN.

    The tree notes every table add/remove (``note_add``/``note_remove``,
    O(1), no device work).  ``sync(tables)``, on the first point lookup
    after a view change, applies the journal: removed tables free their
    rows; each added table takes a free row with ONE in-place row write
    (``set_stack_row``) and records it in ``SSTable.stack_slot``.  An add
    whose table is merged away before any read cancels against its
    remove, so its filter is never built.

    The words live only on the device; the host side is the journal, the
    slot map and the per-row geometry ``meta`` (the probe's launch
    parameters).  The reference also kept a host copy of the words for
    its numpy probe, which the port does not have.  The stack is rebuilt
    when capacity or row width must grow or occupancy falls below 1/4.
    Free rows keep (n_bits=128, k=1) geometry."""

    def __init__(self, device: torch.device):
        self.device = device
        self.filts: Optional[torch.Tensor] = None    # (cap, width) int32
        self.meta = np.zeros((0, 2), np.uint32)      # host (cap, 2)
        self.slots: dict[int, int] = {}              # component cid -> row
        self.free: list[int] = []
        self._add: dict[int, SSTable] = {}           # pending, cid-keyed
        self._remove: list[int] = []                 # pending, cids

    @property
    def cap(self) -> int:
        return 0 if self.filts is None else int(self.filts.shape[0])

    @property
    def width(self) -> int:
        return 0 if self.filts is None else int(self.filts.shape[1])

    def note_add(self, table: SSTable) -> None:
        self._add[table.component.cid] = table

    def note_remove(self, cid: int) -> None:
        if self._add.pop(cid, None) is not None:
            return                       # never materialized: cancelled
        if cid in self.slots:
            self._remove.append(cid)

    def _rebuild(self, tables) -> None:
        cap = max(4, 2 * len(tables))
        width = max(max((t.ensure_bloom().shape[0] for t in tables),
                        default=1), 1)
        self.filts = torch.zeros((cap, width), dtype=torch.int32,
                                 device=self.device)
        self.meta = np.zeros((cap, 2), np.uint32)
        self.meta[:, 0] = 128
        self.meta[:, 1] = 1
        self.slots = {}
        for i, t in enumerate(tables):
            set_stack_row(self.filts, t.ensure_bloom(), i)
            self.meta[i] = (t.n_bits, t.k_hashes)
            self.slots[t.component.cid] = i
            t.stack_slot = i
        self.free = list(range(len(tables), cap))
        self._add.clear()
        self._remove.clear()

    def sync(self, tables) -> tuple[torch.Tensor, np.ndarray]:
        """Apply the pending add/remove journal; returns
        ``(filts, meta)`` (probe rows come from each table's
        ``stack_slot``)."""
        if self.filts is None:
            self._rebuild(tables)
            return self.filts, self.meta
        for cid in self._remove:
            row = self.slots.pop(cid, None)
            if row is not None:
                self.free.append(row)
                self.meta[row] = (128, 1)
        self._remove.clear()
        if self._add:
            adds = list(self._add.values())
            need_w = max(t.ensure_bloom().shape[0] for t in adds)
            n_live = len(self.slots) + len(adds)
            if need_w > self.width or len(adds) > len(self.free) \
                    or (self.cap > 8 and 4 * n_live < self.cap):
                self._rebuild(tables)
                return self.filts, self.meta
            for t in adds:
                row = self.free.pop()
                set_stack_row(self.filts, t.ensure_bloom(), row)
                self.meta[row] = (t.n_bits, t.k_hashes)
                self.slots[t.component.cid] = row
                t.stack_slot = row
            self._add.clear()
        elif self.cap > 8 and 4 * len(self.slots) < self.cap:
            self._rebuild(tables)
        return self.filts, self.meta


@dataclass
class _RunningMerge:
    op: MergeOp
    inputs: list[SSTable]
    drop: bool = False         # reclaim tombstones (bottom-level merge)
    # -- streaming cursor state (opened lazily by ``_open_merge``) -----
    tables: Optional[list] = None          # inputs sorted newest-first
    run_keys: Optional[list] = None        # per-run host key mirrors
    run_vals: Optional[list] = None
    cursors: Optional[np.ndarray] = None   # per-run consumed prefix
    lens: Optional[np.ndarray] = None
    # merged output, written window by window into buffers PREALLOCATED
    # at ``_open_merge`` (capacity = sum of input lens; dedup only
    # shrinks), so ``_finish_merge`` binds views and never concatenates:
    # on the host (the mirrors) and on the device (what the table adopts)
    buf_keys: Optional[np.ndarray] = None
    buf_vals: Optional[np.ndarray] = None
    dev_keys: Optional[torch.Tensor] = field(default=None, repr=False)
    dev_vals: Optional[torch.Tensor] = field(default=None, repr=False)
    emitted: int = 0           # post-dedup entries emitted so far
    tombs_in: int = 0          # input tombstones seen in consumed windows
    # -- one-shot state (``streaming_merge=False`` baseline) -----------
    cursor: int = 0            # entries of the merged stream charged
    merged_keys: Optional[np.ndarray] = None
    merged_vals: Optional[np.ndarray] = None
    merged_dev: Optional[tuple] = field(default=None, repr=False)
    tree: Optional["LSMTree"] = field(default=None, repr=False)


class LSMTree:
    """One LSM tree of a ``StorageGroup``: memtable plane, run levels,
    read view + filter stack, merge policy/scheduler/constraint, and the
    streaming-merge state of its running merges.  Cross-cutting state
    (backend, budget, lock, clock) lives on ``self.group``."""

    def __init__(self, group: "StorageGroup", tree_id: int, name: str,
                 policy: MergePolicy, scheduler: MergeScheduler,
                 constraint: ComponentConstraint, memtable_entries: int,
                 num_memtables: int, unique_keys: float,
                 streaming_merge: bool):
        self.group = group
        self.tree_id = int(tree_id)
        self.name = name
        self.policy = policy
        self.scheduler = scheduler
        self.constraint = constraint
        self.memtable_entries = int(memtable_entries)
        self.num_memtables = int(num_memtables)
        self.unique_keys = unique_keys
        self.streaming_merge = bool(streaming_merge)
        self.meta = ComponentTree(unique_keys=unique_keys)
        self.active = MemTable(self.memtable_entries)
        self.sealed: list[MemTable] = []
        self.tables: dict[int, SSTable] = {}     # component id -> SSTable
        self._order: list[SSTable] = []          # newest-first
        self._fstack = _FilterStack(group.device)
        self._view: Optional[_ReadView] = None
        self._view_epoch = 0                     # bumped on invalidation
        self.running: dict[int, _RunningMerge] = {}
        self._stamp = 0
        self.stalled = False
        self._flush_debt = 0             # flush-quantum overshoot owed
        self.stats = {"puts": 0, "stall_events": 0, "flushes": 0,
                      "merges": 0, "merge_bytes": 0, "merge_touched": 0,
                      "lookups": 0, "bloom_skips": 0,
                      "deletes": 0, "replayed": 0, "tombstones_dropped": 0,
                      "flush_bytes": 0, "logical_bytes": 0}

    @property
    def device(self) -> torch.device:
        return self.group.device

    # ------------------------------------------------------------ memtables
    def seal_active(self) -> None:
        """Seal the active memtable (it becomes a flush candidate) and
        open a fresh one."""
        self.sealed.append(self.active)
        self.active = MemTable(self.memtable_entries)

    def _refresh_stall(self):
        self.stalled = self.constraint.violated(self.meta)

    # ------------------------------------------------------------------ read
    def _read_view(self) -> _ReadView:
        """The cached read view: an O(tables) snapshot of ``_order``.
        Epoch-guarded against the wall-clock driver: a view built while a
        flush/merge invalidates serves this call but is not cached."""
        view = self._view
        if view is None:
            epoch = self._view_epoch
            view = _ReadView(tuple(self._order))
            if epoch == self._view_epoch:
                self._view = view
        return view

    def _view_filters(self, view: _ReadView):
        """Apply the filter stack's pending journal once per view (the
        first point lookup after a background event); scans never call
        this.  Returns ``(filts, meta)``."""
        if view.filts is None and view.tables:
            view.filts, view.meta = self._fstack.sync(self._order)
        return view.filts, view.meta

    def _invalidate_view(self):
        self._view_epoch += 1
        self._view = None

    @staticmethod
    def _order_key(t: SSTable):
        """Newest-first rank of a table in the read view / merge order."""
        return (-t.data_stamp, t.component.level if t.component else 0)

    def get_batch_locked(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized newest-wins lookup (group lock held): memtables
        newest-first, then ONE fused Bloom probe across all disk tables,
        then sorted searches only for surviving (table, key) pairs with
        early exit.  Returns (found, values); tombstone hits resolve the
        key but report "not found"."""
        q = len(keys)
        self.stats["lookups"] += q
        resolved = np.zeros(q, bool)
        vals = np.zeros(q, np.int32)
        for mt in (self.active, *reversed(self.sealed)):
            if resolved.all():
                break
            f, v = mt.get_batch(keys)
            new = f & ~resolved
            vals[new] = v[new]
            resolved |= new
        if not resolved.all():
            view = self._read_view()
            if view.tables:
                filts, meta = self._view_filters(view)
                # the full stack (capacity rows, <= 2x live tables);
                # each table's row is its own stack_slot — no gather
                probed = self.group.backend.probe_multi(filts, meta, keys)
                for table in view.tables:
                    pend = ~resolved
                    if not pend.any():
                        break
                    maybe_t = probed[table.stack_slot]
                    cand = pend & maybe_t
                    self.stats["bloom_skips"] += int((pend & ~maybe_t).sum())
                    if not cand.any():
                        continue
                    idx = np.flatnonzero(cand)
                    f, v = table.search(keys[idx])
                    hit = idx[f]
                    vals[hit] = v[f]
                    resolved[hit] = True
        found = resolved & (vals != TOMBSTONE)
        vals = np.where(found, vals, 0).astype(np.int32)
        return found, vals

    def _scan_runs(self, lo: int, hi: int) -> list[tuple[np.ndarray,
                                                         np.ndarray]]:
        """Per-run ``[lo, hi)`` host windows, NEWEST first (active
        memtable, sealed memtables newest-first, then the read view's
        tables) — the age order the k-way merge dedups by.  Empty windows
        are dropped."""
        runs: list[tuple[np.ndarray, np.ndarray]] = []
        for mt in (self.active, *reversed(self.sealed)):
            ks, vs = mt.scan_range(lo, hi)
            if len(ks):
                runs.append((ks, vs))
        for table in self._read_view().tables:
            ks, vs = table.scan_range(lo, hi)
            if len(ks):
                runs.append((ks, vs))
        return runs

    def scan_range(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Newest-wins range scan: sorted (keys, values) for
        ``lo <= key < hi``, resolved across all live runs in one k-way
        merge.  The run windows are captured under the group lock; the
        merge runs outside it (the windows are immutable snapshots)."""
        with self.group._rlock:
            runs = self._scan_runs(lo, hi)
        if not runs:
            return np.empty(0, np.uint32), np.empty(0, np.int32)
        if len(runs) == 1:
            # copy: the window is a view into live run storage
            ks, vs = drop_tombstones(runs[0][0], runs[0][1])
            return ks.copy(), vs.copy()
        return self.group.backend.scan_merge(runs,
                                             drop_value=int(TOMBSTONE))

    # ------------------------------------------------------- background I/O
    def pump_tree(self, budget_entries: int) -> int:
        """Advance this tree's background work by its quantum of the
        group epoch (group lock held): repay flush-overshoot debt, then
        flushes at strict priority, then merges per the scheduler's
        allocation (largest-remainder apportionment, never exceeding the
        quantum).  Returns entries actually charged."""
        g = self.group
        spent = 0
        repay = min(self._flush_debt, budget_entries)
        self._flush_debt -= repay
        spent += repay
        while self.sealed and spent < budget_entries:
            mt = self.sealed.pop(0)
            keys, vals = mt.seal()
            table = SSTable.build(keys, vals,
                                  level=self.policy.flush_target_level(),
                                  created_at=g.now, device=self.device)
            self._bind_table(table)
            self.stats["flushes"] += 1
            self.stats["flush_bytes"] += len(keys) * ENTRY_BYTES
            cost = len(keys)
            avail = budget_entries - spent
            if cost > avail:
                # atomic flush overshoot carried as debt
                self._flush_debt += cost - avail
                spent = budget_entries
            else:
                spent += cost
            self._collect_merges()
        if spent >= budget_entries:
            return spent
        self._collect_merges()
        ops = [rm.op for rm in self.running.values()]
        alloc = self.scheduler.allocate(ops) if ops else {}
        remaining = budget_entries - spent
        shares = sorted((op_id, frac) for op_id, frac in alloc.items()
                        if frac > 0)
        if shares and remaining > 0:
            quanta = apportion_largest_remainder(shares, remaining)
            for (op_id, _), quantum in zip(shares, quanta):
                if quantum > 0:
                    # through the GROUP, so wrapping the engine's
                    # ``_advance_merge`` instruments every tree
                    spent += g._advance_merge(self.running[op_id], quantum)
            assert spent <= budget_entries, \
                "merge quanta exceeded the pump budget"
        return spent

    def _bind_table(self, table: SSTable) -> None:
        """Register a freshly built run as this tree's NEWEST table:
        stamp it, seal its checksum, and enter it into the scheduling
        plane and the read plane (prepend to ``_order``, journal the
        filter-stack add)."""
        self._stamp += 1
        table.data_stamp = self._stamp
        table.component.stamp = float(self._stamp)
        table.seal_checksum()
        self.meta.add(table.component)
        self.tables[table.component.cid] = table
        self._order.insert(0, table)
        self._fstack.note_add(table)
        self._invalidate_view()

    def _collect_merges(self):
        for op in self.policy.collect_merges(self.meta, self.group.now):
            inputs = [self.tables[c.cid] for c in op.inputs]
            self.running[op.op_id] = _RunningMerge(op=op, inputs=inputs,
                                                   tree=self)

    def pending_entries(self) -> int:
        """This tree's background I/O debt in entries: flush debt,
        sealed memtables, and the unconsumed inputs of every running
        merge.  The group's pump splits its budget by this number."""
        self._collect_merges()
        pending = self._flush_debt + sum(len(m) for m in self.sealed)
        for rm in self.running.values():
            if rm.lens is not None:       # streaming cursor open
                pending += int((rm.lens - rm.cursors).sum())
            elif rm.merged_keys is not None:   # one-shot materialized
                pending += len(rm.merged_keys) - rm.cursor
            else:
                # unopened cursor: the inputs bound it; a zero-input op
                # still counts as live work so the group routes it budget
                pending += max(sum(len(t) for t in rm.inputs), 1)
        return pending

    # -- merge execution (the paper's unit of schedulable I/O) -------------
    def _open_merge(self, rm: _RunningMerge):
        """Set up the streaming cursor: inputs newest-first (data_stamp
        order; on equal stamps the LOWER level is newer), zero cursors,
        and the output buffers allocated once."""
        rm.tables = sorted(rm.inputs, key=self._order_key)
        rm.drop = self._tombstone_drop_safe(rm)
        rm.run_keys = [t.keys_np for t in rm.tables]
        rm.run_vals = [t.vals_np for t in rm.tables]
        rm.lens = np.array([len(k) for k in rm.run_keys], np.int64)
        rm.cursors = np.zeros(len(rm.tables), np.int64)
        cap = int(rm.lens.sum())
        rm.buf_keys = np.empty(cap, np.uint32)
        rm.buf_vals = np.empty(cap, np.int32)

    def _tombstone_drop_safe(self, rm: _RunningMerge) -> bool:
        """May this merge reclaim tombstones?  Safe iff NO live table
        OLDER than the merge's output overlaps its key range (checked once
        at open; tables born later are newer than the output)."""
        in_cids = {t.component.cid for t in rm.inputs}
        out_key = (-max(t.data_stamp for t in rm.inputs),
                   rm.op.output_level)
        lo = min(t.component.key_lo for t in rm.inputs)
        hi = max(t.component.key_hi for t in rm.inputs)
        for t in self._order:
            if t.component.cid in in_cids:
                continue
            if self._order_key(t) > out_key and \
                    t.component.key_lo < hi and lo < t.component.key_hi:
                return False
        return True

    def _merge_cut(self, rm: _RunningMerge,
                   target: int) -> tuple[np.ndarray, int]:
        """The merge-path pivot: the largest key-boundary cut whose
        remaining input entries number at most ``target`` (binary search
        for the pivot key over the uint32 key space; per-run window ends
        by ``searchsorted`` on the host mirrors).  When even the first key
        group exceeds ``target``, that group is taken whole as forced
        progress.  Returns ``(stops, consumed)``."""
        cur, lens, ks = rm.cursors, rm.lens, rm.run_keys
        rem = int((lens - cur).sum())
        if rem <= target:
            return lens.copy(), rem

        def below(p: int) -> int:
            c = 0
            for i, k in enumerate(ks):
                if cur[i] < lens[i]:
                    c += max(0, int(np.searchsorted(k, np.uint32(p)))
                             - int(cur[i]))
            return c

        lo, hi = 0, 0xFFFFFFFF      # sentinel key never stored: p covers all
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if below(mid) <= target:
                lo = mid
            else:
                hi = mid - 1
        stops = np.array(
            [min(int(lens[i]),
                 max(int(cur[i]), int(np.searchsorted(ks[i],
                                                      np.uint32(lo)))))
             for i in range(len(ks))], np.int64)
        consumed = int((stops - cur).sum())
        if consumed == 0:
            # forced progress: the whole first key group (<= k entries)
            nxt = min(int(ks[i][cur[i]]) for i in range(len(ks))
                      if cur[i] < lens[i])
            stops = np.array(
                [min(int(lens[i]),
                     max(int(cur[i]),
                         int(np.searchsorted(ks[i], np.uint32(nxt),
                                             side="right"))))
                 for i in range(len(ks))], np.int64)
            consumed = int((stops - cur).sum())
        return stops, consumed

    def _advance_merge(self, rm: _RunningMerge, quantum: int) -> int:
        """Advance one merge by ~``quantum`` output entries: cut the next
        window at a global key boundary and merge ONLY that window on the
        device, so a quantum costs O(quantum + k).  Emitted (post-dedup)
        entries are what the budget is charged for."""
        if not self.streaming_merge:
            return self._advance_merge_oneshot(rm, quantum)
        if rm.tables is None:
            self._open_merge(rm)
        if int((rm.lens - rm.cursors).sum()) == 0:
            self.group._finish_merge(rm)
            return 0
        starts = rm.cursors
        stops, consumed = self._merge_cut(rm, quantum)
        drop = int(TOMBSTONE) if rm.drop else None
        if rm.drop:
            # reclaimed markers counted window by window (O(consumed))
            rm.tombs_in += sum(
                int((rm.run_vals[i][starts[i]:stops[i]]
                     == TOMBSTONE).sum())
                for i in range(len(rm.tables)))
        wk, wv, (dk, dv) = self.group.backend.merge_kway_window(
            [(t.keys, t.vals) for t in rm.tables],
            starts.tolist(), stops.tolist(), drop_value=drop)
        take = len(wk)
        assert take <= max(quantum, 1), "window emitted beyond its quantum"
        rm.cursors = stops
        rm.buf_keys[rm.emitted:rm.emitted + take] = wk
        rm.buf_vals[rm.emitted:rm.emitted + take] = wv
        self._accumulate_device(rm, dk, dv, take)
        rm.emitted += take
        rm.op.written += take
        self.stats["merge_bytes"] += take * ENTRY_BYTES
        self.stats["merge_touched"] += consumed
        if int((rm.lens - rm.cursors).sum()) == 0:
            self.group._finish_merge(rm)
        return take

    def _accumulate_device(self, rm: _RunningMerge, dk: torch.Tensor,
                           dv: torch.Tensor, take: int) -> None:
        """Copy a window's device output into the merge's device output
        tensor, preallocated at the merge's input size on the first
        non-empty window, at the window's slice."""
        if take == 0:
            return
        if rm.dev_keys is None:
            cap = int(rm.lens.sum())
            rm.dev_keys = torch.empty(cap, dtype=torch.int32,
                                      device=self.device)
            rm.dev_vals = torch.empty(cap, dtype=torch.int32,
                                      device=self.device)
        rm.dev_keys[rm.emitted:rm.emitted + take].copy_(dk)
        rm.dev_vals[rm.emitted:rm.emitted + take].copy_(dv)

    def _materialize_merge(self, rm: _RunningMerge):
        """One-shot baseline (``streaming_merge=False``): the full merged
        run at the first quantum — an unbounded compute spike under the
        lock, which is what the streaming cursor removes."""
        self.stats["merge_touched"] += sum(len(t) for t in rm.inputs)
        tables = sorted(rm.inputs, key=self._order_key)
        rm.drop = self._tombstone_drop_safe(rm)
        drop = int(TOMBSTONE) if rm.drop else None
        if rm.drop:
            rm.tombs_in = sum(int((t.vals_np == TOMBSTONE).sum())
                              for t in rm.inputs)
        rm.merged_keys, rm.merged_vals, rm.merged_dev = \
            self.group.backend.merge_kway(
                [(t.keys, t.vals) for t in tables], drop_value=drop)

    def _advance_merge_oneshot(self, rm: _RunningMerge, quantum: int) -> int:
        if rm.merged_keys is None:
            self._materialize_merge(rm)
        total = len(rm.merged_keys)
        take = min(quantum, total - rm.cursor)
        if take > 0:
            # the merged run is whole already; the cursor paces charging
            rm.cursor += take
            rm.op.written += take
            self.stats["merge_bytes"] += take * ENTRY_BYTES
        if rm.cursor >= total:
            self.group._finish_merge(rm)
        return max(take, 0)

    def _finish_merge(self, rm: _RunningMerge):
        # O(1) output binding: views of the preallocated buffers (host
        # and device); the one-shot baseline binds its merged arrays
        if rm.buf_keys is not None:
            keys = rm.buf_keys[:rm.emitted]
            vals = rm.buf_vals[:rm.emitted]
            dev_pair = None if rm.dev_keys is None else \
                (rm.dev_keys[:rm.emitted], rm.dev_vals[:rm.emitted])
        elif rm.merged_keys is not None:
            keys, vals = rm.merged_keys, rm.merged_vals
            dev_pair = rm.merged_dev
        else:  # finished before any quantum ran (all-empty inputs)
            keys = np.empty(0, np.uint32)
            vals = np.empty(0, np.int32)
            dev_pair = None
        stamp = max(t.data_stamp for t in rm.inputs)
        if rm.drop:
            # every input tombstone died here (winners to the drop mask,
            # shadowed ones to dedup)
            self.stats["tombstones_dropped"] += rm.tombs_in
        # keep the policy's metadata model in sync with the real output
        rm.op.output_size = float(len(keys))
        rm.op.written = float(len(keys))
        in_cids = {c.cid for c in rm.op.inputs}
        for cid in in_cids:
            self.tables.pop(cid, None)
            self._fstack.note_remove(cid)
        self._order = [t for t in self._order
                       if t.component.cid not in in_cids]
        outs = self.policy.complete_merge(self.meta, rm.op, self.group.now)

        # partitioned policies may split the output into several files
        def _bind(comp, ks, vs, dev=None):
            table = SSTable.build(ks, vs, level=comp.level,
                                  created_at=self.group.now,
                                  device=self.device, dev=dev)
            table.component = comp
            table.data_stamp = stamp
            comp.stamp = float(stamp)
            # the policy's overlap selection must see the REAL key span;
            # an empty output file spans nothing
            if len(ks):
                comp.key_lo = float(ks[0]) / 2**32
                comp.key_hi = (float(ks[-1]) + 1) / 2**32
            else:
                comp.key_lo = comp.key_hi = 0.0
            table.seal_checksum()
            self.tables[comp.cid] = table

        if len(outs) == 1:
            _bind(outs[0], keys, vals, dev_pair)
        else:
            # contiguous slice views at np.array_split's boundaries; the
            # device output splits at the same boundaries
            n = max(len(outs), 1)
            sizes = np.full(n, len(keys) // n, np.int64)
            sizes[:len(keys) % n] += 1
            bounds = np.concatenate([[0], np.cumsum(sizes)])
            for j, comp in enumerate(outs):
                lo, hi = int(bounds[j]), int(bounds[j + 1])
                dv = (dev_pair[0][lo:hi], dev_pair[1][lo:hi]) \
                    if dev_pair is not None else None
                _bind(comp, keys[lo:hi], vals[lo:hi], dv)
        # bisect-insert the outputs at their shared (-stamp, level) rank
        out_tables = [self.tables[c.cid] for c in outs]
        if out_tables:          # a policy may complete a merge to nothing
            pos = bisect.bisect_left(self._order,
                                     self._order_key(out_tables[0]),
                                     key=self._order_key)
            self._order[pos:pos] = out_tables
        for t in out_tables:
            self._fstack.note_add(t)
        self.running.pop(rm.op.op_id, None)
        self._invalidate_view()
        self.stats["merges"] += 1
        self._collect_merges()

    # ---------------------------------------------------------------- info
    def start_full_merge(self) -> bool:
        """Queue ONE merge of every live table to the deepest level (the
        ``compact_all`` step).  Returns False when there is nothing to
        compact (<= 1 run, no tombstones)."""
        live = list(self._order)
        if not live:
            return False
        if len(live) == 1 and int((live[0].vals_np == TOMBSTONE).sum()) == 0:
            return False
        comps = [t.component for t in live]
        op = MergeOp(inputs=comps,
                     output_level=max(self.meta.max_level(),
                                      max(c.level for c in comps)),
                     output_size=float(sum(len(t) for t in live)))
        self.running[op.op_id] = _RunningMerge(op=op, inputs=live,
                                               tree=self)
        return True

    def total_entries(self) -> int:
        return sum(len(t) for t in self.tables.values()) + \
            sum(len(m) for m in self.sealed) + len(self.active)

    def num_components(self) -> int:
        return self.meta.num_components()

    def live_entries(self) -> int:
        """Distinct keys whose newest version is not a tombstone (an
        O(n) full-range scan)."""
        return int(len(self.scan_range(0, 0xFFFFFFFF)[0]))


# canonical stats key order (the reference engine's dict order; the WAL
# counters stay 0 until the durability plane is ported)
_STATS_ORDER = ("puts", "stall_events", "flushes", "merges", "merge_bytes",
                "merge_touched", "lookups", "bloom_skips", "deletes",
                "replayed", "tombstones_dropped", "wal_entries", "wal_bytes",
                "wal_syncs", "flush_bytes", "logical_bytes")


class StorageGroup:
    """LSM trees sharing ONE I/O plane: backend (device), budget, lock
    and clock.  This slice has one tree, the primary; the group surface
    delegates to it."""

    def __init__(self, policy: MergePolicy, scheduler: MergeScheduler,
                 constraint: ComponentConstraint | None = None,
                 memtable_entries: int = 4096, num_memtables: int = 2,
                 unique_keys: float = 1e6, merge_block: int = 256,
                 streaming_merge: bool = True,
                 device: "str | torch.device" = "cuda",
                 wal=None, faults=None, indexes=()):
        if wal is not None:
            raise _not_ported("wal")
        if faults is not None:
            raise _not_ported("faults")
        if indexes:
            raise _not_ported("indexes")
        self.backend = ExecBackend(device, merge_block=merge_block)
        self.device = self.backend.device
        self.merge_block = self.backend.merge_block
        self.streaming_merge = bool(streaming_merge)
        self._rlock = threading.RLock()
        self.now = 0.0
        self._recorder = None            # optional WriteTraceRecorder
        self.trees: list[LSMTree] = [
            LSMTree(self, 0, "primary", policy, scheduler,
                    constraint or NoConstraint(), int(memtable_entries),
                    int(num_memtables), unique_keys,
                    self.streaming_merge)]

    def attach_write_recorder(self, recorder) -> None:
        """Attach a ``metrics.WriteTraceRecorder`` (or None to detach):
        the write path reports (admitted, offered) once per call."""
        self._recorder = recorder

    # ------------------------------------------------------------------ write
    def put(self, key: int, value: int) -> bool:
        """Returns False when the write must stall (component constraint
        or no free memtable slot) — the caller decides to retry."""
        if np.int32(value) == TOMBSTONE:
            raise ValueError("value -2**31 is reserved (delete tombstone)")
        with self._rlock:
            return self._put_batch_locked(np.array([key], np.uint32),
                                          np.array([value], np.int32)) == 1

    def put_batch(self, keys, values) -> int:
        """Bulk admission in chunks sized to the memtable's room.
        Returns the count accepted before the first stall."""
        keys = np.asarray(keys, np.uint32)
        values = np.asarray(values, np.int32)
        if (values == TOMBSTONE).any():
            raise ValueError("value -2**31 is reserved (delete tombstone)")
        with self._rlock:
            return self._put_batch_locked(keys, values)

    def delete(self, key: int) -> bool:
        """Blind delete: admit a TOMBSTONE for ``key``.  True says the
        delete was admitted, not that the key existed."""
        return self.delete_batch(np.array([key], np.uint32)) == 1

    def delete_batch(self, keys) -> int:
        """Bulk blind deletes with ``put_batch`` semantics."""
        keys = np.asarray(keys, np.uint32)
        vals = np.full(len(keys), TOMBSTONE, np.int32)
        with self._rlock:
            return self._put_batch_locked(keys, vals, deletes=True)

    def _put_batch_locked(self, keys, values, deletes: bool = False) -> int:
        primary = self.trees[0]
        n = len(keys)
        if (keys == SENTINEL_KEY).any():
            raise ValueError("key 2**32-1 is reserved")
        n_ok = 0
        while n_ok < n:
            primary._refresh_stall()
            if primary.stalled:
                # a constraint-induced rejection is a stall event
                primary.stats["stall_events"] += 1
                break
            if primary.active.full:
                if len(primary.sealed) >= primary.num_memtables - 1:
                    primary.stats["stall_events"] += 1
                    break
                primary.seal_active()
            take = min(n - n_ok,
                       primary.active.capacity - len(primary.active))
            took = primary.active.put_batch(keys[n_ok:n_ok + take],
                                            values[n_ok:n_ok + take])
            assert took == take, "memtable admitted less than its room"
            n_ok += took
            primary.stats["deletes" if deletes else "puts"] += took
        primary.stats["logical_bytes"] += n_ok * ENTRY_BYTES
        if self._recorder is not None and n > 0:
            self._recorder.on_puts(n_ok, n)
        return n_ok

    # ------------------------------------------------------------------ read
    def get(self, key: int):
        found, vals = self.get_batch(np.array([key], np.uint32))
        return int(vals[0]) if found[0] else None

    def get_batch(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Point reads: one fused multi-table Bloom probe behind a
        newest-first walk with early exit."""
        keys = np.asarray(keys, np.uint32)
        with self._rlock:
            return self.trees[0].get_batch_locked(keys)

    def scan_range(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Newest-wins range scan ``lo <= key < hi`` (one k-way merge)."""
        return self.trees[0].scan_range(lo, hi)

    # ------------------------------------------------------- background I/O
    def pump(self, budget_entries: int) -> int:
        """Advance background work by ``budget_entries`` of write I/O —
        one group epoch: the budget is split across trees by background
        debt (largest remainder); each tree spends its quantum on flushes
        (strict priority) then merges per its scheduler.  Returns entries
        actually charged."""
        with self._rlock:
            return self._pump_locked(budget_entries)

    def _pump_locked(self, budget_entries: int) -> int:
        spent = 0
        self.now += 1.0
        debts = [(t.tree_id, d) for t in self.trees
                 if (d := t.pending_entries()) > 0]
        if len(debts) == 1:
            spent += self.trees[debts[0][0]].pump_tree(budget_entries)
        elif debts:
            total = float(sum(d for _, d in debts))
            quanta = apportion_largest_remainder(
                [(tid, d / total) for tid, d in debts], budget_entries)
            for (tid, _), q in zip(debts, quanta):
                if q > 0:
                    spent += self.trees[tid].pump_tree(q)
        for t in self.trees:
            t._refresh_stall()
        return spent

    def drain(self, budget_entries: int = 1 << 30, max_pumps: int = 10_000):
        """Pump until no background work remains (tests, shutdown)."""
        with self._rlock:
            for _ in range(max_pumps):
                busy = False
                for t in self.trees:
                    t._collect_merges()
                    busy = busy or t.sealed or t.running
                if not busy:
                    break
                self.pump(budget_entries)

    # --------------------------------------------------- single-tree surface
    @property
    def tree(self) -> ComponentTree:
        """The primary tree's scheduling-plane model."""
        return self.trees[0].meta

    @property
    def sealed(self) -> list:
        return self.trees[0].sealed

    @property
    def tables(self) -> dict:
        return self.trees[0].tables

    @property
    def _order(self) -> list:
        return self.trees[0]._order

    @property
    def stats(self) -> dict:
        """Merged counters (sum over trees) in the reference's key order.
        A fresh dict per access."""
        out = dict.fromkeys(_STATS_ORDER, 0)
        for t in self.trees:
            for k, v in t.stats.items():
                out[k] += v
        return out

    # merge advance/finish dispatch per merge via ``rm.tree``: every
    # tree's pump routes its merges through these two entry points, so
    # wrapping them on the engine instance instruments the whole group
    def _advance_merge(self, rm: _RunningMerge, quantum: int) -> int:
        return (rm.tree or self.trees[0])._advance_merge(rm, quantum)

    def _finish_merge(self, rm: _RunningMerge) -> None:
        (rm.tree or self.trees[0])._finish_merge(rm)

    # ------------------------------------------------------------------ info
    def lock(self) -> threading.RLock:
        """The group's reentrant lock: the ``BackgroundDriver`` holds it
        around ``pump``; foreground callers sharing a group with a driver
        hold it around every engine call."""
        return self._rlock

    def num_components(self) -> int:
        with self._rlock:
            return sum(t.num_components() for t in self.trees)

    def total_entries(self) -> int:
        with self._rlock:
            return sum(t.total_entries() for t in self.trees)

    def compact_all(self, budget_per_pump: int = 1 << 30) -> None:
        """Force-merge every tree into one bottom run: flush every
        memtable, drain policy merges, then merge ALL live tables to the
        deepest level in one op, reclaiming every tombstone."""
        with self._rlock:
            for t in self.trees:
                if len(t.active):
                    t.seal_active()
            self.drain(budget_per_pump)
            started = False
            for t in self.trees:
                started = t.start_full_merge() or started
            if started:
                self.drain(budget_per_pump)

    def live_entries(self) -> int:
        return sum(t.live_entries() for t in self.trees)

    def amplification(self) -> dict:
        """Write/space amplification snapshot (``amplification_stats``)."""
        from .metrics import amplification_stats
        with self._rlock:
            return amplification_stats(self.stats,
                                       physical_entries=self.total_entries(),
                                       live_entries=self.live_entries())

    def enable_scrub(self, *args, **kwargs):
        raise _not_ported("faults")

    def close(self) -> None:
        """Nothing to release until the durability plane is ported."""

    def __enter__(self) -> "StorageGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LSMEngine(StorageGroup):
    """A single-partition LSM store (uint32 keys -> int32 values) on
    ``device`` ("cuda" unless the caller asks for "cpu")."""


def engine_from_numpy(state: dict, policy: MergePolicy,
                      scheduler: MergeScheduler,
                      constraint: ComponentConstraint | None = None,
                      memtable_entries: int = 4096, num_memtables: int = 2,
                      unique_keys: float = 1e6, merge_block: int = 256,
                      streaming_merge: bool = True,
                      device: "str | torch.device" = "cuda") -> LSMEngine:
    """An engine whose runs, order, levels, stamps and memtable contents
    equal ``state``, a reference engine's carried across as plain numpy
    arrays and numbers:

    * ``runs``: newest-first list of dicts with ``keys`` (uint32),
      ``vals`` (int32), ``level``, ``stamp``, ``created_at``, ``size``,
      ``key_lo`` and ``key_hi`` (the scheduling-plane component);
    * ``levels``: ``{level: [run index, ...]}``, the scheduling plane's
      per-level order (the policies read it);
    * ``active``: the active memtable's (keys, vals) in insertion order,
      ``sealed``: the sealed memtables' oldest first;
    * ``stamp``: the tree's last data stamp, ``now``: the group clock.

    Merges that were running in the source are not carried: the policy
    collects them again from the restored levels."""
    eng = LSMEngine(policy, scheduler, constraint,
                    memtable_entries=memtable_entries,
                    num_memtables=num_memtables, unique_keys=unique_keys,
                    merge_block=merge_block, streaming_merge=streaming_merge,
                    device=device)
    tree = eng.trees[0]
    eng.now = float(state["now"])
    built = []
    for run in state["runs"]:
        t = SSTable.build(run["keys"], run["vals"], level=int(run["level"]),
                          created_at=float(run["created_at"]),
                          device=eng.device)
        t.component = Component(size=float(run["size"]),
                                level=int(run["level"]),
                                key_lo=float(run["key_lo"]),
                                key_hi=float(run["key_hi"]),
                                created_at=float(run["created_at"]),
                                stamp=float(run["stamp"]))
        t.data_stamp = int(run["stamp"])
        t.seal_checksum()
        tree.tables[t.component.cid] = t
        tree._order.append(t)
        tree._fstack.note_add(t)
        built.append(t)
    for level, idxs in sorted(state["levels"].items()):
        for i in idxs:
            tree.meta.level(int(level)).append(built[i].component)
    tree._stamp = int(state["stamp"])
    for keys, vals in state["sealed"]:
        mt = MemTable(tree.memtable_entries)
        mt.put_batch(keys, vals)
        tree.sealed.append(mt)
    tree.active.put_batch(*state["active"])
    tree._invalidate_view()
    return eng


class BackgroundDriver:
    """Wall-clock driver: pumps an engine at ``bandwidth_bytes_per_s`` on a
    daemon thread (tests use pump() directly)."""

    def __init__(self, engine: LSMEngine, bandwidth_bytes_per_s: float,
                 quantum_s: float = 0.01):
        self.engine = engine
        self.rate = bandwidth_bytes_per_s
        self.quantum_s = quantum_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the ENGINE's lock, so `with engine.lock():` on the foreground
        # path excludes the pump
        self._lock = engine.lock()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        # Pace by monotonic elapsed time, carrying the undelivered-entry
        # deficit across iterations: the budget owed is always
        # elapsed * rate, so slow iterations are repaid by larger quanta
        # (capped at 4x pace, so one slow pump cannot snowball into ever
        # longer lock holds).
        t0 = time.monotonic()
        delivered = 0.0
        per_s = self.rate / ENTRY_BYTES
        q_max = max(1, int(4 * per_s * self.quantum_s))
        while not self._stop.is_set():
            deficit = (time.monotonic() - t0) * per_s - delivered
            quantum = min(int(deficit), q_max)
            if quantum >= 1:
                with self._lock:
                    self.engine.pump(quantum)
                delivered += quantum
            self._stop.wait(self.quantum_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def close(self) -> None:
        """Stop the pump thread, then close the engine.  Idempotent."""
        self.stop()
        self.engine.close()

    def __enter__(self) -> "BackgroundDriver":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
