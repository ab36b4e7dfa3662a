"""Arrival processes and clients of the paper's two-phase methodology
(Section 3.2): the open client (Figure 5b) draws arrivals from an
``ArrivalProcess``, the closed client (Figure 5a) writes as fast as its
capacity allows.  ``twophase.EngineSystem`` integrates them per tick and
replays the result as real ``put_batch`` traffic.  (The fluid simulator
that shares them in the reference package is not part of this module.)
"""
from __future__ import annotations

from dataclasses import dataclass

EPS = 1e-9
INF = float("inf")


class ArrivalProcess:
    """Piecewise-constant arrival rate (entries/s)."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def next_change(self, t: float) -> float:
        return INF

    def cum_entries(self, t0: float, t1: float) -> float:
        """Exact integral of ``rate`` over ``[t0, t1)``, stepping through
        the piecewise-constant segments — the tick-level arrival count the
        engine-backed harness offers to ``put_batch``."""
        total, t = 0.0, t0
        while t < t1 - EPS:
            nxt = min(self.next_change(t), t1)
            if nxt <= t:
                nxt = t1
            total += self.rate(t) * (nxt - t)
            t = nxt
        return total


class ConstantArrival(ArrivalProcess):
    def __init__(self, rate: float):
        self._rate = float(rate)

    def rate(self, t: float) -> float:
        return self._rate


class BurstyArrival(ArrivalProcess):
    """Alternates normal_rate for normal_s seconds, burst_rate for burst_s
    (Figure 13: 2000/s for 25 min, 8000/s for 5 min)."""

    def __init__(self, normal_rate: float, burst_rate: float,
                 normal_s: float, burst_s: float):
        self.nr, self.br = float(normal_rate), float(burst_rate)
        self.ns, self.bs = float(normal_s), float(burst_s)

    def _phase(self, t: float) -> tuple[bool, float]:
        period = self.ns + self.bs
        u = t % period
        if u < self.ns:
            return False, (t - u) + self.ns
        return True, (t - u) + period

    def rate(self, t: float) -> float:
        burst, _ = self._phase(t)
        return self.br if burst else self.nr

    def next_change(self, t: float) -> float:
        _, nxt = self._phase(t)
        return nxt


@dataclass
class OpenClient:
    """Open system (Figure 5b): arrivals are independent of processing."""

    arrivals: ArrivalProcess
    closed = False


@dataclass
class ClosedClient:
    """Closed system (Figure 5a): next write submitted only after the
    previous completes; arrival rate == service capacity."""

    n_threads: int = 1
    per_thread_rate: float = 250_000.0  # in-memory insert rate, entries/s
    closed = True

    @property
    def capacity(self) -> float:
        return self.n_threads * self.per_thread_rate
