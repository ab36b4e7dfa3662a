"""Core LSM data structures shared by the simulator and the real engine.

Sizes are tracked in *entries* (the paper uses 1 KB entries, so bytes =
entries * entry_size).  Key ranges are modelled on the unit interval [0, 1)
— the real engine maps uint64 keys onto it, the simulator uses it directly
for partitioned-merge overlap computation.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

_next_id = itertools.count()


def fresh_id() -> int:
    return next(_next_id)


@dataclass
class Component:
    """An immutable on-disk LSM component (or a range-partitioned file)."""

    size: float                      # entries
    level: int = 0                   # level hint (policies may ignore)
    key_lo: float = 0.0              # [key_lo, key_hi) in unit key space
    key_hi: float = 1.0
    created_at: float = 0.0          # simulation / wall time of creation
    stamp: float = 0.0               # data age (NOT creation time): the
                                     # real engine mirrors its flush/merge
                                     # data stamps here so policies can
                                     # make age-aware choices; the fluid
                                     # simulator leaves it 0
    cid: int = field(default_factory=fresh_id)
    merging: bool = False            # currently an input of an active merge

    def overlaps(self, other: "Component") -> bool:
        return self.key_lo < other.key_hi and other.key_lo < self.key_hi

    def __repr__(self) -> str:  # compact, for traces
        return (f"C{self.cid}(L{self.level},{self.size:.0f}e,"
                f"[{self.key_lo:.2f},{self.key_hi:.2f}))")


class MergeState(Enum):
    PENDING = "pending"
    RUNNING = "running"
    PAUSED = "paused"
    DONE = "done"


@dataclass
class MergeOp:
    """A merge operation created by a merge policy.

    ``output_size`` is the number of entries the merge will *write* — the
    paper throttles the SSD **write** bandwidth of flushes and merges
    (Section 3.1), so a merge's I/O demand is its output size.  The greedy
    scheduler ranks operations by *remaining input pages* (Figure 7 line
    12), which we track via ``remaining_input``.
    """

    inputs: list[Component]
    output_level: int
    output_size: float               # entries to write
    output_ranges: list[tuple[float, float]] = field(default_factory=list)
    op_id: int = field(default_factory=fresh_id)
    state: MergeState = MergeState.PENDING
    written: float = 0.0             # entries written so far
    created_at: float = 0.0

    def __post_init__(self) -> None:
        for c in self.inputs:
            c.merging = True
        if not self.output_ranges:
            lo = min(c.key_lo for c in self.inputs)
            hi = max(c.key_hi for c in self.inputs)
            self.output_ranges = [(lo, hi)]

    @property
    def total_input(self) -> float:
        return sum(c.size for c in self.inputs)

    @property
    def remaining_output(self) -> float:
        return max(0.0, self.output_size - self.written)

    @property
    def remaining_input(self) -> float:
        """Remaining input entries to consume (greedy's ranking key)."""
        if self.output_size <= 0:
            return 0.0
        frac = min(1.0, self.written / self.output_size)
        return self.total_input * (1.0 - frac)

    @property
    def done(self) -> bool:
        return self.remaining_output <= 1e-9


@dataclass
class FlushOp:
    """A flush of a sealed memory component to a new Level-0 component."""

    size: float                      # entries to write
    written: float = 0.0
    op_id: int = field(default_factory=fresh_id)

    @property
    def remaining(self) -> float:
        return max(0.0, self.size - self.written)


class LSMTree:
    """Scheduling-plane view of an LSM-tree: component metadata per level.

    ``levels[i]`` is ordered oldest → newest for unpartitioned levels and by
    key range for partitioned levels.  The same structure backs both the
    discrete-event simulator and the real engine, so policies and
    schedulers are exercised identically in both.
    """

    def __init__(self, unique_keys: float, entry_size: int = 1024):
        self.levels: dict[int, list[Component]] = {}
        self.unique_keys = float(unique_keys)
        self.entry_size = entry_size

    # -- structural helpers ------------------------------------------------
    def level(self, i: int) -> list[Component]:
        return self.levels.setdefault(i, [])

    def add(self, comp: Component) -> None:
        self.level(comp.level).append(comp)

    def remove(self, comp: Component) -> None:
        self.level(comp.level).remove(comp)

    def all_components(self) -> list[Component]:
        return [c for lvl in self.levels.values() for c in lvl]

    def num_components(self) -> int:
        return sum(len(lvl) for lvl in self.levels.values())

    def num_at(self, i: int) -> int:
        return len(self.levels.get(i, []))

    def level_size(self, i: int) -> float:
        return sum(c.size for c in self.levels.get(i, []))

    def total_size(self) -> float:
        return sum(c.size for c in self.all_components())

    def max_level(self) -> int:
        occupied = [i for i, lvl in self.levels.items() if lvl]
        return max(occupied) if occupied else 0

    # -- merge output size model -------------------------------------------
    def merged_size(self, sizes: list[float], key_fraction: float = 1.0) -> float:
        """Expected output entries when merging components with ``sizes``.

        Uniform-update model: each input holds distinct keys drawn uniformly
        from the ``key_fraction`` slice of the ``unique_keys`` key space, so
        the union follows the inclusion–exclusion expectation
        ``U * (1 - prod(1 - s_i / U))``.  This is what bounds the largest
        level at ~``unique_keys`` entries and what lets merges reclaim
        obsolete versions, exactly the dynamics the paper relies on.
        """
        u = self.unique_keys * key_fraction
        if u <= 0:
            return float(sum(sizes))
        prod = 1.0
        for s in sizes:
            prod *= max(0.0, 1.0 - min(s, u) / u)
        return u * (1.0 - prod)
