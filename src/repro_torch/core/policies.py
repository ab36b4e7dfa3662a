"""LSM merge policies (Sections 2.1, 5.3, 6.1).

A policy decides *which* components to merge; the scheduler (scheduler.py)
decides how to execute the resulting operations.  Policies operate purely
on the scheduling-plane ``LSMTree`` metadata so they can drive both the
fluid simulator and the real engine.

Implemented policies:
  * ``TieringPolicy``              — T components per level, merged together.
  * ``LevelingPolicy``             — one component per level (+ optional
                                      dynamic-level-size adjustment [31]).
  * ``SizeTieredPolicy``           — the HBase/BigTable practical variant
                                      (size ratio + min/max mergeable), with
                                      the paper's ``force_min`` fix.
  * ``PartitionedLevelingPolicy``  — the LevelDB variant (L0 runs + fixed
                                      size files, score-based selection,
                                      round-robin / choose-best), with the
                                      paper's exact-T0 testing fix.
"""
from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Optional

from .component import Component, LSMTree, MergeOp


class MergePolicy(ABC):
    """Base class. ``collect_merges`` is invoked by the runtime after every
    flush/merge completion and returns newly created merge operations (whose
    inputs it marks as ``merging``)."""

    def __init__(self, memtable_entries: float, unique_keys: float):
        self.memtable_entries = float(memtable_entries)
        self.unique_keys = float(unique_keys)

    # -- policy interface ---------------------------------------------------
    @abstractmethod
    def collect_merges(self, tree: LSMTree, now: float) -> list[MergeOp]:
        ...

    @abstractmethod
    def expected_components(self) -> int:
        """Expected steady-state #disk components (constraint is ~2x this)."""

    @abstractmethod
    def initial_tree(self, tree: LSMTree) -> None:
        """Populate ``tree`` as if freshly loaded with ``unique_keys``."""

    def flush_target_level(self) -> int:
        return 0

    def complete_merge(self, tree: LSMTree, op: MergeOp, now: float) -> list[Component]:
        """Default completion: replace inputs with one output component."""
        for c in op.inputs:
            tree.remove(c)
        out = Component(size=op.output_size, level=op.output_level,
                        key_lo=op.output_ranges[0][0], key_hi=op.output_ranges[0][1],
                        created_at=now)
        tree.add(out)
        return [out]

    # -- shared helpers -----------------------------------------------------
    def num_levels(self, size_ratio: float) -> int:
        return max(1, math.ceil(math.log(max(self.unique_keys / self.memtable_entries, size_ratio), size_ratio)))


# ---------------------------------------------------------------------------
class TieringPolicy(MergePolicy):
    """Tiering (Figure 2b): when a level accumulates T components they are
    merged into one component at the next level."""

    def __init__(self, size_ratio: int, memtable_entries: float, unique_keys: float):
        super().__init__(memtable_entries, unique_keys)
        self.T = int(size_ratio)

    def collect_merges(self, tree: LSMTree, now: float) -> list[MergeOp]:
        ops: list[MergeOp] = []
        for lvl in sorted(tree.levels):
            comps = tree.level(lvl)
            if any(c.merging for c in comps):
                continue  # at most one active merge per level (S 5.1.3)
            if len(comps) >= self.T:
                inputs = comps[: self.T]  # oldest T
                out_size = tree.merged_size([c.size for c in inputs])
                ops.append(MergeOp(inputs=list(inputs), output_level=lvl + 1,
                                   output_size=out_size, created_at=now))
        return ops

    def expected_components(self) -> int:
        return self.T * self.num_levels(self.T)

    def initial_tree(self, tree: LSMTree) -> None:
        # Last level holds the data; intermediate levels hold (T-1)/2
        # components on average.  The testing phase's excluded 20-minute
        # warm-up (Section 3.2) converges this to steady state.
        L = self.num_levels(self.T)
        remaining = self.unique_keys
        for lvl in range(L - 1, 0, -1):
            csize = self.memtable_entries * (self.T ** lvl)
            n = max(0, (self.T - 1) // 2)
            for _ in range(int(n)):
                if remaining <= csize:
                    break
                tree.add(Component(size=csize, level=lvl))
                remaining -= csize
        if remaining > 0:
            tree.add(Component(size=remaining, level=L))


# ---------------------------------------------------------------------------
class LevelingPolicy(MergePolicy):
    """Leveling (Figure 2a): one component per level; level i is merged with
    incoming data from level i-1 until it reaches capacity M*T^i, then it is
    merged into level i+1.

    ``dynamic_level_size`` applies the RocksDB dynamic-level-size
    optimization [31]: capacities are derived top-down from the data size so
    the largest level stays nearly full (used in the Figure 11 sweep).
    """

    def __init__(self, size_ratio: int, memtable_entries: float, unique_keys: float,
                 dynamic_level_size: bool = False):
        super().__init__(memtable_entries, unique_keys)
        self.T = int(size_ratio)
        self.dynamic = dynamic_level_size
        self.L = self.num_levels(self.T)
        self._caps = self._capacities()

    def _capacities(self) -> dict[int, float]:
        caps: dict[int, float] = {}
        if self.dynamic:
            cap = self.unique_keys
            for lvl in range(self.L, 0, -1):
                caps[lvl] = cap
                cap /= self.T
        else:
            for lvl in range(1, self.L + 1):
                caps[lvl] = self.memtable_entries * (self.T ** lvl)
        return caps

    def capacity(self, lvl: int) -> float:
        if lvl in self._caps:
            return self._caps[lvl]
        return self.memtable_entries * (self.T ** lvl)

    def collect_merges(self, tree: LSMTree, now: float) -> list[MergeOp]:
        """bLSM-style swap semantics (the concurrency model Section 5.1.3
        assumes): when a level-i component fills it freezes and drains
        into level i+1 while a FRESH level-i component keeps accepting
        merges from level i-1 — up to one merge per level runs
        concurrently instead of the whole tree serializing."""
        ops: list[MergeOp] = []
        comps = tree.all_components()

        # Age-adjacency guard.  Swap semantics can transiently leave
        # several runs on a level, and tree-list order is insertion
        # order, not data-age order — merging incoming data with an OLD
        # resident while a fresher run sits elsewhere in the tree yields
        # an output whose data stamp (max over inputs) claims recency the
        # skipped run violates, so stamp-ordered newest-wins reads in the
        # real engine return stale values.  Invariant: live runs
        # partition the flush-age axis into contiguous intervals, so an
        # incoming run may only merge with the GLOBALLY next-older live
        # run; when that run is not an eligible candidate (busy, or on a
        # different level), the incoming run is emitted solo instead —
        # always sound, since a solo run skips nothing.  The engine
        # mirrors data stamps onto components; the fluid simulator leaves
        # every stamp 0, where the rule degrades to the seed's
        # last-inserted pick (identical fluid dynamics).
        def target_for(x_stamp: float, cands: list[Component]):
            if not cands:
                return []
            if x_stamp <= 0:            # fluid sim: no data stamps
                return [cands[-1]]
            older = [c for c in comps if c.stamp < x_stamp]
            if not older:
                return []
            nxt = max(older, key=lambda c: c.stamp)
            return [nxt] if nxt in cands else []

        # L0 (flushed components) -> the growing (non-frozen) L1
        l0 = tree.level(0)
        if l0 and not any(c.merging for c in l0):
            l1_grow = [c for c in tree.level(1)
                       if not c.merging and c.size < self.capacity(1)]
            inputs = list(l0) + target_for(min(c.stamp for c in l0),
                                           l1_grow)
            out = tree.merged_size([c.size for c in inputs])
            ops.append(MergeOp(inputs=inputs, output_level=1,
                               output_size=out, created_at=now))
        # full Li -> growing Li+1 (oldest data first, so a newer frozen
        # run can never leapfrog an older sibling's drain)
        for lvl in range(1, tree.max_level() + 1):
            if lvl >= self.L:
                continue
            full = sorted((c for c in tree.level(lvl)
                           if not c.merging and
                           c.size >= self.capacity(lvl)),
                          key=lambda c: c.stamp)
            for comp in full:
                nxt_grow = [c for c in tree.level(lvl + 1)
                            if not c.merging and
                            (lvl + 1 == self.L or
                             c.size < self.capacity(lvl + 1))]
                inputs = [comp] + target_for(comp.stamp, nxt_grow)
                out = tree.merged_size([c.size for c in inputs])
                ops.append(MergeOp(inputs=inputs, output_level=lvl + 1,
                                   output_size=out, created_at=now))
        return ops

    def expected_components(self) -> int:
        return self.L

    def initial_tree(self, tree: LSMTree) -> None:
        remaining = self.unique_keys
        for lvl in range(self.L, 0, -1):
            cap = self.capacity(lvl)
            size = min(remaining, cap if lvl == self.L else cap / 2.0)
            if size <= 0:
                continue
            tree.add(Component(size=size, level=lvl))
            remaining -= size


# ---------------------------------------------------------------------------
class SizeTieredPolicy(MergePolicy):
    """The size-tiered policy used by HBase/BigTable (Section 5.3).

    Components form one age-ordered sequence (held at level 0 of the tree,
    oldest first).  A merge window [i..j] (oldest index i) is eligible when
      sizes[i] <= T * sum(sizes[i+1..j])   and   min <= j-i+1 <= max,
    matching the Figure 18 example.  Each policy execution examines the
    longest suffix of components newer than any merging component (the
    HBase prefix rule) and schedules the oldest eligible window, maximizing
    the window length (or exactly ``min`` under ``force_min`` — the paper's
    fix for measuring a *sustainable* lower-bound throughput).
    """

    def __init__(self, size_ratio: float, memtable_entries: float, unique_keys: float,
                 min_merge: int = 2, max_merge: int = 10, force_min: bool = False):
        super().__init__(memtable_entries, unique_keys)
        self.T = float(size_ratio)
        self.min_merge = int(min_merge)
        self.max_merge = int(max_merge)
        self.force_min = bool(force_min)

    def collect_merges(self, tree: LSMTree, now: float) -> list[MergeOp]:
        ops: list[MergeOp] = []
        while True:
            seq = tree.level(0)  # oldest -> newest
            start = 0
            for idx in range(len(seq) - 1, -1, -1):
                if seq[idx].merging:
                    start = idx + 1
                    break
            window = self._find_window(seq, start)
            if window is None:
                return ops
            i, j = window
            inputs = seq[i: j + 1]
            out = tree.merged_size([c.size for c in inputs])
            ops.append(MergeOp(inputs=list(inputs), output_level=0,
                               output_size=out, created_at=now))

    def _find_window(self, seq: list[Component], start: int) -> Optional[tuple[int, int]]:
        n = len(seq)
        limit = self.min_merge if self.force_min else self.max_merge
        for i in range(start, n - self.min_merge + 1):
            younger = 0.0
            for j in range(i + 1, min(n, i + limit)):
                younger += seq[j].size
                if (j - i + 1) >= self.min_merge and seq[i].size <= self.T * younger:
                    # extend j as far as the eligibility and limit allow
                    jj = j
                    while (jj + 1 < n and (jj + 1 - i + 1) <= limit):
                        jj += 1
                        younger += seq[jj].size
                    return (i, jj)
        return None

    def complete_merge(self, tree: LSMTree, op: MergeOp, now: float) -> list[Component]:
        seq = tree.level(0)
        pos = min(seq.index(c) for c in op.inputs)
        for c in op.inputs:
            seq.remove(c)
        out = Component(size=op.output_size, level=0,
                        created_at=min(c.created_at for c in op.inputs))
        seq.insert(pos, out)  # output keeps the age position of its inputs
        return [out]

    def expected_components(self) -> int:
        # ln(U/M)/ln(1+1/T)-ish; the paper simply configures 50.
        return 50

    def initial_tree(self, tree: LSMTree) -> None:
        tree.add(Component(size=self.unique_keys, level=0, created_at=-1e9))


# ---------------------------------------------------------------------------
class PartitionedLevelingPolicy(MergePolicy):
    """LevelDB-style partitioned leveling (Section 6).

    Level 0 holds whole-range flushed runs; levels >= 1 hold fixed-size
    files with disjoint key ranges.  Scores: L0 = #runs / l0_min_merge;
    level i >= 1 = level_size / capacity(i).  The highest score >= 1 is
    merged.  ``l0_merge_all`` reproduces LevelDB's merge-as-many-as-possible
    behaviour (unsustainable, Figure 21); setting it False merges exactly
    ``l0_min_merge`` runs — the paper's fix (Figure 23).
    """

    def __init__(self, size_ratio: int, memtable_entries: float, unique_keys: float,
                 file_entries: float = 65536.0,       # 64 MB / 1 KB
                 l1_capacity: float = 1310720.0,      # 1280 MB
                 l0_min_merge: int = 4,
                 selection: str = "round_robin",      # or "choose_best"
                 l0_merge_all: bool = True,
                 max_concurrent: int = 1):
        super().__init__(memtable_entries, unique_keys)
        self.T = int(size_ratio)
        self.file_entries = float(file_entries)
        self.l1_capacity = float(l1_capacity)
        self.l0_min_merge = int(l0_min_merge)
        self.selection = selection
        self.l0_merge_all = bool(l0_merge_all)
        self.max_concurrent = int(max_concurrent)
        self._cursor: dict[int, float] = {}
        nl = 1
        cap = self.l1_capacity
        while cap < self.unique_keys:
            cap *= self.T
            nl += 1
        self.num_partitioned_levels = nl

    def capacity(self, lvl: int) -> float:
        return self.l1_capacity * (self.T ** (lvl - 1))

    # -- selection ----------------------------------------------------------
    def _age_safe(self, tree: LSMTree, lvl: int, f: Component) -> bool:
        """Stamp-laundering audit (the partitioned analogue of
        ``LevelingPolicy``'s age-adjacency guard).  Merging ``f`` with its
        level-(lvl+1) overlaps produces an output stamped ``max`` over the
        inputs; any key range the output covers BEYOND ``f``'s own span
        carries data older than that stamp.  If a live component at a
        shallower level overlaps the output range with a SMALLER stamp, it
        holds newer versions (the level invariant) that the output would
        outrank under stamp-ordered newest-wins reads — so the merge must
        wait until that component has drained past.  Stamp 0 means the
        fluid simulator (no data stamps): every merge is safe, degrading
        to the seed's selection exactly."""
        inputs = [f] + [o for o in tree.level(lvl + 1) if f.overlaps(o)]
        s_star = max(c.stamp for c in inputs)
        if s_star <= 0:
            return True
        lo = min(c.key_lo for c in inputs)
        hi = max(c.key_hi for c in inputs)
        in_ids = {c.cid for c in inputs}
        for g_lvl in range(1, lvl + 1):
            for g in tree.level(g_lvl):
                if g.cid not in in_ids and g.key_lo < hi \
                        and g.key_hi > lo and g.stamp < s_star:
                    return False
        return True

    def _pick_file(self, tree: LSMTree, lvl: int) -> Optional[Component]:
        files = [c for c in tree.level(lvl) if not c.merging]
        files = [c for c in files
                 if not any(o.merging and c.overlaps(o) for o in tree.level(lvl + 1))]
        files = [c for c in files if self._age_safe(tree, lvl, c)]
        if not files:
            return None
        if self.selection == "choose_best":
            nxt = tree.level(lvl + 1)
            return min(files, key=lambda f: (sum(1 for o in nxt if f.overlaps(o)), f.key_lo))
        cur = self._cursor.get(lvl, 0.0)
        files.sort(key=lambda f: f.key_lo)
        for f in files:
            if f.key_lo >= cur:
                self._cursor[lvl] = f.key_hi
                return f
        self._cursor[lvl] = files[0].key_hi
        return files[0]

    def collect_merges(self, tree: LSMTree, now: float) -> list[MergeOp]:
        ops: list[MergeOp] = []
        active = sum(1 for c in tree.all_components() if c.merging)
        while len(ops) + (1 if active else 0) <= self.max_concurrent:
            op = self._next_merge(tree, now)
            if op is None:
                return ops
            ops.append(op)
            active = 0 if not active else active
        return ops

    def _next_merge(self, tree: LSMTree, now: float) -> Optional[MergeOp]:
        scores: list[tuple[float, int]] = []
        l0_free = [c for c in tree.level(0) if not c.merging]
        if not any(c.merging for c in tree.level(0)):
            scores.append((len(l0_free) / self.l0_min_merge, 0))
        for lvl in range(1, self.num_partitioned_levels):
            scores.append((tree.level_size(lvl) / self.capacity(lvl), lvl))
        scores.sort(reverse=True)
        for score, lvl in scores:
            if score < 1.0:
                return None
            if lvl == 0:
                if any(c.merging for c in tree.level(1)):
                    continue
                k = len(l0_free) if self.l0_merge_all else self.l0_min_merge
                # oldest-k by DATA age, not created_at: flushes completing
                # in the same pump share created_at, and merging a newer
                # run while skipping an older tied sibling launders the
                # skipped run's L1 shadow above its stamp (newest-wins
                # inversion).  Stamps are unique in the real engine; the
                # cid tiebreak keeps the fluid sim (all stamps 0) on the
                # seed's flush order.
                inputs = sorted(l0_free,
                                key=lambda c: (c.stamp, c.created_at,
                                               c.cid))[:k]
                inputs += list(tree.level(1))
                out = tree.merged_size([c.size for c in inputs])
                return MergeOp(inputs=inputs, output_level=1, output_size=out,
                               output_ranges=[(0.0, 1.0)], created_at=now)
            f = self._pick_file(tree, lvl)
            if f is None:
                continue
            overlapping = [o for o in tree.level(lvl + 1)
                           if f.overlaps(o) and not o.merging]
            inputs = [f] + overlapping
            lo = min(c.key_lo for c in inputs)
            hi = max(c.key_hi for c in inputs)
            frac = max(hi - lo, 1e-12)
            out = tree.merged_size([c.size for c in inputs], key_fraction=frac)
            return MergeOp(inputs=inputs, output_level=lvl + 1, output_size=out,
                           output_ranges=[(lo, hi)], created_at=now)
        return None

    def complete_merge(self, tree: LSMTree, op: MergeOp, now: float) -> list[Component]:
        for c in op.inputs:
            tree.remove(c)
        lo, hi = op.output_ranges[0]
        n_files = max(1, int(math.ceil(op.output_size / self.file_entries)))
        width = (hi - lo) / n_files
        outs: list[Component] = []
        per = op.output_size / n_files
        for k in range(n_files):
            outs.append(Component(size=per, level=op.output_level,
                                  key_lo=lo + k * width, key_hi=lo + (k + 1) * width,
                                  created_at=now))
        for c in outs:
            tree.add(c)
        tree.level(op.output_level).sort(key=lambda c: c.key_lo)
        return outs

    def expected_components(self) -> int:
        total_files = int(self.unique_keys / self.file_entries)
        return total_files + self.l0_min_merge

    def initial_tree(self, tree: LSMTree) -> None:
        remaining = self.unique_keys
        for lvl in range(self.num_partitioned_levels, 0, -1):
            cap = self.capacity(lvl)
            size = min(remaining, cap if lvl == self.num_partitioned_levels else cap / 2.0)
            if size <= 0:
                continue
            n_files = max(1, int(math.ceil(size / self.file_entries)))
            per, width = size / n_files, 1.0 / n_files
            for k in range(n_files):
                tree.add(Component(size=per, level=lvl, key_lo=k * width,
                                   key_hi=(k + 1) * width))
            remaining -= size


POLICIES = {
    "tiering": TieringPolicy,
    "leveling": LevelingPolicy,
    "size_tiered": SizeTieredPolicy,
    "partitioned_leveling": PartitionedLevelingPolicy,
}
