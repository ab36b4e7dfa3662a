"""Component constraints (Section 5.1.1).

A constraint is the condition under which in-memory writes must be stalled
(or slowed) because too many disk components have accumulated.  The paper
argues for *global* constraints sized at ~2x the expected component count.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

from .component import LSMTree


class ComponentConstraint(ABC):
    @abstractmethod
    def violated(self, tree: LSMTree) -> bool:
        ...

    def describe(self) -> str:
        return type(self).__name__


class NoConstraint(ComponentConstraint):
    def violated(self, tree: LSMTree) -> bool:
        return False


class GlobalConstraint(ComponentConstraint):
    """Stall when the total number of disk components exceeds ``max_total``."""

    def __init__(self, max_total: int):
        self.max_total = max_total

    def violated(self, tree: LSMTree) -> bool:
        return tree.num_components() > self.max_total

    def describe(self) -> str:
        return f"global(<= {self.max_total})"


class LocalConstraint(ComponentConstraint):
    """Stall when any level holds more than ``max_per_level`` components.

    bLSM-style (at most two components per level); evaluated in Figure 12.
    Partitioned levels (disjoint files) are exempt — the per-level limit is
    about *overlapping* components a query must reconcile.
    """

    def __init__(self, max_per_level: int, partitioned_levels_exempt: bool = True):
        self.max_per_level = max_per_level
        self.exempt = partitioned_levels_exempt

    def violated(self, tree: LSMTree) -> bool:
        for lvl, comps in tree.levels.items():
            if self.exempt and lvl >= 1 and _is_partitioned(comps):
                continue
            if len(comps) > self.max_per_level:
                return True
        return False

    def describe(self) -> str:
        return f"local(<= {self.max_per_level}/level)"


class L0Constraint(ComponentConstraint):
    """LevelDB-style: stop writes when Level 0 holds >= ``stop`` runs."""

    def __init__(self, stop: int = 12):
        self.stop = stop

    def violated(self, tree: LSMTree) -> bool:
        return tree.num_at(0) >= self.stop

    def describe(self) -> str:
        return f"l0(< {self.stop})"


def _is_partitioned(comps) -> bool:
    if len(comps) <= 1:
        return False
    return any(c.key_hi - c.key_lo < 1.0 for c in comps)
