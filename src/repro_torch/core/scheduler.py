"""Merge schedulers (Section 4/5.1): how I/O bandwidth is allocated among
concurrently active merge operations.

A scheduler maps the set of live merge operations to bandwidth *fractions*
(summing to <= 1).  The same allocation law drives both the fluid
discrete-event simulator (``sim.py``) and the real engine's token-bucket
rate limiters (``engine.py``), so the paper's scheduling decisions are
exercised identically in simulation and on the real data plane.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence

from .component import MergeOp


def apportion_largest_remainder(shares: Sequence[tuple[int, float]],
                                budget: int) -> list[int]:
    """Split an integer ``budget`` across fractional ``shares`` by
    largest-remainder apportionment: flooring each share (the seed's
    ``int(budget * frac)``) drops every sub-1 share, so small fractions
    starve and budget silently vanishes at small quanta — instead the
    floored shares are topped up, largest fractional part first (ties by
    id), until they sum to ``min(budget, round(sum(targets)))``.

    ``shares`` is a sequence of ``(id, fraction)`` pairs (fractions sum
    to <= 1); the returned quanta align with ``shares`` and always sum to
    at most ``budget``.  Shared by three budget-splitting layers — merge
    quanta within one tree (``LSMTree.pump_tree``), the pump epoch
    across a ``StorageGroup``'s trees (primary + secondary indexes,
    split by background debt), and the fleet's ``GlobalBudgetArbiter``
    (shard budgets across engines) — so the sub-1-share starvation fix
    lives in exactly one place."""
    if not shares or budget <= 0:
        return [0] * len(shares)
    targets = [budget * frac for _, frac in shares]
    quanta = [int(t) for t in targets]
    total = min(budget, int(round(sum(targets))))
    leftover = total - sum(quanta)
    order = sorted(range(len(shares)),
                   key=lambda i: (quanta[i] - targets[i], shares[i][0]))
    for i in order[:leftover]:
        quanta[i] += 1
    return quanta


class MergeScheduler(ABC):
    name: str = "abstract"

    @abstractmethod
    def allocate(self, ops: Sequence[MergeOp]) -> dict[int, float]:
        """Return {op_id: bandwidth fraction}.  Fractions sum to <= 1."""

    def reset(self) -> None:  # pragma: no cover - stateless by default
        pass


class SingleThreadedScheduler(MergeScheduler):
    """One merge at a time, in creation (FIFO) order, never preempted.

    The paper shows this is insufficient for full merges: while a level-i
    merge runs, ~T^i/L flushed components pile up (Section 5.1.3).
    """

    name = "single"

    def __init__(self) -> None:
        self._active: int | None = None

    def reset(self) -> None:
        self._active = None

    def allocate(self, ops: Sequence[MergeOp]) -> dict[int, float]:
        if not ops:
            self._active = None
            return {}
        live = {op.op_id for op in ops}
        if self._active not in live:
            self._active = min(ops, key=lambda o: o.op_id).op_id
        return {self._active: 1.0}


class FairScheduler(MergeScheduler):
    """Even split among all active merges (HBase/Cassandra/RocksDB default).

    The right scheduler for the *testing* phase: merges at every level make
    steady progress, so the measured maximum throughput is not inflated by
    starving large merges (Section 5.2.2).
    """

    name = "fair"

    def allocate(self, ops: Sequence[MergeOp]) -> dict[int, float]:
        if not ops:
            return {}
        share = 1.0 / len(ops)
        return {op.op_id: share for op in ops}


class GreedyScheduler(MergeScheduler):
    """Full bandwidth to the merge with the fewest remaining input pages
    (Figure 7).  Theorem 2: for a static set of same-arity merges this
    minimizes the number of disk components at every time instant.

    ``k`` generalizes to the smallest-k merges for budgets a single merge
    cannot saturate (Section 5.1.5).
    """

    name = "greedy"

    def __init__(self, k: int = 1):
        assert k >= 1
        self.k = k

    def allocate(self, ops: Sequence[MergeOp]) -> dict[int, float]:
        if not ops:
            return {}
        chosen = sorted(ops, key=lambda o: (o.remaining_input, o.op_id))[: self.k]
        share = 1.0 / len(chosen)
        return {op.op_id: share for op in chosen}


SCHEDULERS = {
    "single": SingleThreadedScheduler,
    "fair": FairScheduler,
    "greedy": GreedyScheduler,
}


def make_scheduler(name: str, **kw) -> MergeScheduler:
    return SCHEDULERS[name](**kw)
