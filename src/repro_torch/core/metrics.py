"""Trace capture and metric extraction, shared by the fluid simulator and
the real engine's two-phase harness.

Both backends record cumulative arrivals A(t) and cumulative completions
S(t) as piecewise-linear breakpoint lists.  Open-system write latency of
the x-th write is then exactly  S^-1(x) - A^-1(x)  (queuing + processing),
computed by vectorized inversion — deterministic, no sampling noise.  The
fluid simulator emits breakpoints at its event boundaries;
``WriteTraceRecorder`` ingests the real engine's discrete write-path
events (wall- or virtual-clock timestamps, one call per ``put_batch``)
into the same curves, so every metric below works unchanged for either
backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def rollup_stats(per_shard: "list[dict] | tuple[dict, ...]") -> dict:
    """Aggregate per-shard engine ``stats`` dicts (or any dicts of numeric
    counters) into one fleet-wide dict: every key present in any shard is
    summed across shards (missing keys count 0).  The fleet's
    ``LSMFleet.stats`` property and the fleet benchmarks use this so
    ``stall_events`` / ``merge_touched`` / admitted-offered accounting
    reads identically per-shard and fleet-wide."""
    out: dict = {}
    for stats in per_shard:
        for k, v in stats.items():
            out[k] = out.get(k, 0) + v
    return out


def amplification_stats(stats: dict, physical_entries: int | None = None,
                        live_entries: int | None = None) -> dict:
    """Write/space amplification from an engine (or rolled-up fleet)
    ``stats`` dict — the LSM survey's two cost axes, computable because
    entries can die (deletes write tombstones).

    ``write_amp`` = bytes physically written (flush + merge + WAL) per
    logical byte ingested (puts AND deletes — a tombstone is a write).
    ``space_amp`` = physical entries stored (every version, every run)
    per LIVE entry (distinct keys whose newest version is not a
    tombstone); pass ``physical_entries``/``live_entries`` from the
    store (``LSMEngine.amplification`` / ``LSMFleet.amplification`` do)
    — with them omitted only ``write_amp`` is reported.  A fully
    deleted, fully compacted store has ``physical_entries ~ 0``, which
    the durability tests pin."""
    logical = float(stats.get("logical_bytes", 0))
    written = float(stats.get("flush_bytes", 0)
                    + stats.get("merge_bytes", 0)
                    + stats.get("wal_bytes", 0))
    out = {"logical_bytes": logical, "bytes_written": written,
           "write_amp": written / logical if logical > 0 else 0.0}
    if physical_entries is not None:
        live = int(live_entries or 0)
        out["physical_entries"] = int(physical_entries)
        out["live_entries"] = live
        out["space_amp"] = float(physical_entries) / max(live, 1)
    return out


def _invert(pts_t: np.ndarray, pts_v: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Given monotone piecewise-linear (t, v) breakpoints, find t(v)."""
    idx = np.searchsorted(pts_v, values, side="left")
    idx = np.clip(idx, 1, len(pts_v) - 1)
    v0, v1 = pts_v[idx - 1], pts_v[idx]
    t0, t1 = pts_t[idx - 1], pts_t[idx]
    dv = np.maximum(v1 - v0, 1e-12)
    return t0 + (values - v0) / dv * (t1 - t0)


@dataclass
class Trace:
    arrival_t: list[float] = field(default_factory=lambda: [0.0])
    arrival_v: list[float] = field(default_factory=lambda: [0.0])
    service_t: list[float] = field(default_factory=lambda: [0.0])
    service_v: list[float] = field(default_factory=lambda: [0.0])
    capacity_t: list[float] = field(default_factory=list)   # (t, capacity entries/s)
    capacity_v: list[float] = field(default_factory=list)
    comp_t: list[float] = field(default_factory=list)       # (t, #disk components)
    comp_v: list[int] = field(default_factory=list)
    stalls: list[tuple[float, float]] = field(default_factory=list)
    merges_completed: int = 0
    merge_sizes: list[float] = field(default_factory=list)  # entries written
    merge_arity: list[int] = field(default_factory=list)
    duration: float = 0.0
    closed_system: bool = False
    n_clients: int = 1

    # -- recording helpers ----------------------------------------------
    def record_arrival(self, t: float, cum: float) -> None:
        if cum > self.arrival_v[-1] or t > self.arrival_t[-1]:
            self.arrival_t.append(t)
            self.arrival_v.append(cum)

    def record_service(self, t: float, cum: float) -> None:
        if cum > self.service_v[-1] or t > self.service_t[-1]:
            self.service_t.append(t)
            self.service_v.append(cum)

    def record_capacity(self, t: float, c: float) -> None:
        if not self.capacity_t or self.capacity_v[-1] != c:
            self.capacity_t.append(t)
            self.capacity_v.append(c)

    def record_components(self, t: float, n: int) -> None:
        self.comp_t.append(t)
        self.comp_v.append(n)

    # -- metrics ----------------------------------------------------------
    @property
    def total_written(self) -> float:
        return self.service_v[-1]

    def throughput(self, t_from: float = 0.0, t_to: float | None = None) -> float:
        t_to = t_to if t_to is not None else self.duration
        st = np.asarray(self.service_t)
        sv = np.asarray(self.service_v)
        v0 = float(np.interp(t_from, st, sv))
        v1 = float(np.interp(t_to, st, sv))
        return (v1 - v0) / max(t_to - t_from, 1e-9)

    def windowed_throughput(self, window: float = 30.0) -> tuple[np.ndarray, np.ndarray]:
        edges = np.arange(0.0, self.duration + window, window)
        st = np.asarray(self.service_t)
        sv = np.asarray(self.service_v)
        cum = np.interp(edges, st, sv)
        return edges[1:], np.diff(cum) / window

    def write_latency_percentiles(self, pcts=(50, 90, 99, 99.9),
                                  n: int = 200_001,
                                  t_from: float = 0.0) -> dict[float, float]:
        """Latency (queue + processing) of the x-th write, for open systems."""
        at = np.asarray(self.arrival_t)
        av = np.asarray(self.arrival_v)
        stt = np.asarray(self.service_t)
        sv = np.asarray(self.service_v)
        lo = float(np.interp(t_from, at, av))
        # only writes that were *completed* in-window have defined latency;
        # pending writes at the end are right-censored -> extend service
        # line flat (their latency is a lower bound, conservative).
        hi = min(av[-1], sv[-1])
        if hi <= lo:
            return {p: 0.0 for p in pcts}
        xs = np.linspace(lo, hi, n)
        t_arr = _invert(at, av, xs)
        t_done = _invert(stt, sv, xs)
        lat = np.maximum(t_done - t_arr, 0.0)
        return {p: float(np.percentile(lat, p)) for p in pcts}

    def processing_latency_percentiles(self, pcts=(50, 90, 99, 99.9),
                                       n: int = 200_001,
                                       t_from: float = 0.0) -> dict[float, float]:
        """Per-write processing time = inverse instantaneous capacity at the
        write's completion time (the delay injected into that write), with
        stalled intervals contributing the remaining stall length for the
        writes in flight.  Closed systems additionally expose stall time to
        the ``n_clients`` in-flight writes only (Figure 5a discussion).
        ``t_from`` excludes writes completed before it (warm-up cutoff,
        matching ``write_latency_percentiles``)."""
        if not self.capacity_t:
            return {p: 0.0 for p in pcts}
        stt = np.asarray(self.service_t)
        sv = np.asarray(self.service_v)
        lo = float(np.interp(t_from, stt, sv)) if t_from > 0.0 else 0.0
        if sv[-1] <= lo:
            return {p: 0.0 for p in pcts}
        xs = np.linspace(lo, sv[-1], n)
        t_done = _invert(stt, sv, xs)
        ct = np.asarray(self.capacity_t)
        cv = np.asarray(self.capacity_v)
        idx = np.clip(np.searchsorted(ct, t_done, side="right") - 1, 0, len(cv) - 1)
        cap = cv[idx]
        lat = 1.0 / np.maximum(cap, 1e-9)
        if self.closed_system and self.stalls:
            # in-flight writes at each stall onset wait out the stall
            # (warm-up stalls are excluded together with warm-up writes;
            # a stall straddling the cutoff contributes its in-window part)
            extra = [s1 - max(s0, t_from) for (s0, s1) in self.stalls
                     if s1 > t_from] * self.n_clients
            if extra:
                lat = np.concatenate([lat, np.asarray(extra)])
        return {p: float(np.percentile(lat, p)) for p in pcts}

    def stall_time(self) -> float:
        return sum(s1 - s0 for (s0, s1) in self.stalls)

    def max_components(self) -> int:
        return max(self.comp_v) if self.comp_v else 0

    def summary(self) -> dict:
        return {
            "throughput": self.throughput(),
            "stall_time": self.stall_time(),
            "n_stalls": len(self.stalls),
            "merges": self.merges_completed,
            "max_components": self.max_components(),
        }


class LatencyRecorder:
    """Per-operation latency sampler for wall-clock foreground loops (the
    tail-latency benchmark's writer/reader threads).

    ``observe`` appends one operation's latency in seconds; ``percentiles``
    summarizes.  Callers measuring under a concurrent background plane
    should drive an OPEN loop — schedule operations at fixed arrival
    times and observe ``completion - scheduled`` rather than
    ``completion - issue`` — so a stall charges every operation it
    delays instead of just the one that happened to be in flight
    (coordinated-omission-free, the discipline the paper's running-phase
    latency metric assumes).
    """

    def __init__(self):
        self._samples: list[float] = []

    def __len__(self) -> int:
        return len(self._samples)

    def observe(self, seconds: float) -> None:
        self._samples.append(float(seconds))

    def percentiles(self, pcts=(50.0, 99.0, 99.9)) -> dict[float, float]:
        if not self._samples:
            return {float(p): 0.0 for p in pcts}
        a = np.asarray(self._samples)
        return {float(p): float(np.percentile(a, p)) for p in pcts}

    def summary(self) -> dict:
        p = self.percentiles()
        return {"n": len(self), "p50": p[50.0], "p99": p[99.0],
                "p999": p[99.9], "max": float(max(self._samples))
                if self._samples else 0.0}


class WriteTraceRecorder:
    """Ingests the real engine's discrete write-path events into a ``Trace``.

    The engine calls ``on_puts(admitted, offered)`` once per ``put`` /
    ``put_batch`` (one call per batch — the hot path stays vectorized);
    the harness calls ``on_arrivals(cum)`` when it generates client
    arrivals and ``finish(duration)`` at run end.  Timestamps come from
    ``clock`` — ``time.monotonic`` relative to the run start for the
    wall-clock harness, a virtual tick counter for the deterministic one —
    so the resulting arrival/service curves, stall intervals and capacity
    steps feed ``Trace``'s fluid-trace metrics unchanged.

    A stall interval opens at the first attempt that admits less than it
    offered (``admitted < offered``) and closes at the next attempt that
    admits anything — the writer-observed stall, exactly what the paper's
    write-latency metric charges.  Capacity drops to 0 during the stall so
    ``processing_latency_percentiles`` sees the injected delay.
    """

    def __init__(self, trace: "Trace", clock, capacity: float):
        self.trace = trace
        self.clock = clock
        self.capacity = float(capacity)
        self.cum = 0.0
        self.offered = 0.0        # cumulative entries offered (admitted or
                                  # not) — with ``cum`` (admitted), the
                                  # pair ``rollup_stats`` aggregates for
                                  # fleet-wide admitted/offered accounting
        self._stall_t0: float | None = None
        trace.record_capacity(0.0, self.capacity)

    @property
    def admitted(self) -> float:
        return self.cum

    def counters(self) -> dict:
        """The recorder's cumulative counters in ``rollup_stats`` shape."""
        return {"admitted": self.cum, "offered": self.offered,
                "stall_intervals": len(self.trace.stalls)
                + (1 if self._stall_t0 is not None else 0)}

    @property
    def stalled(self) -> bool:
        return self._stall_t0 is not None

    def _now(self) -> float:
        """Clock reading clamped to the trace's duration: a wall-clock
        harness can observe a put slightly after its cutoff (the loop's
        duration check happens before a possibly-blocking engine call),
        and an event stamped past ``duration`` would invert the stall
        interval ``finish`` closes at ``duration``."""
        t = self.clock()
        d = self.trace.duration
        return min(t, d) if d > 0 else t

    def on_puts(self, admitted: int, offered: int) -> None:
        if offered <= 0:
            return
        self.offered += offered
        t = self._now()
        if self._stall_t0 is not None and admitted > 0:
            # close the stall with a flat service plateau so latency
            # inversion sees no progress during [stall_t0, t]
            self.trace.record_service(t, self.cum)
            self.trace.stalls.append((self._stall_t0, t))
            self.trace.record_capacity(t, self.capacity)
            self._stall_t0 = None
        if admitted > 0:
            self.cum += admitted
            self.trace.record_service(t, self.cum)
        if admitted < offered and self._stall_t0 is None:
            self.trace.record_service(t, self.cum)
            self.trace.record_capacity(t, 0.0)
            self._stall_t0 = t

    def on_arrivals(self, cum: float) -> None:
        self.trace.record_arrival(self._now(), cum)

    def finish(self, duration: float) -> None:
        if self._stall_t0 is not None:
            self.trace.stalls.append((self._stall_t0, duration))
            self._stall_t0 = None
        self.trace.record_service(duration, self.cum)
