"""Parity of the PyTorch port's storage engine with the JAX reference, on
the CPU.

The same workload, made from fixed numpy seeds, drives the reference
``repro.core.engine.LSMEngine`` (``backend="host"``) and the port's
``repro_torch.core.engine.LSMEngine`` (``device="cpu"``, so every merge
window, scan and probe runs the kernels' plain PyTorch twins): puts and
deletes, odd pump quanta, and point reads and range scans mid-stream,
across the tiering, leveling and partitioned policies, streaming and
one-shot merges.  Keys range over the whole uint32 space, so keys
>= 2**31 are in every run.

Tolerance: exact equality throughout — every ``get_batch`` and
``scan_range`` result, every merge's output run, the run layout, and the
``stats`` counters are compared bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.engine import LSMEngine as RefEngine
from repro.core import policies as ref_pol
from repro.core.scheduler import make_scheduler as ref_sched
from repro_torch.core import policies as pol
from repro_torch.core.engine import LSMEngine, engine_from_numpy
from repro_torch.core.scheduler import make_scheduler

torch.set_num_threads(1)

MEMTABLE = 64
UNIQUE = 2048
BLOCK = 64


def _policy(mod, name: str):
    if name == "tiering":
        return mod.TieringPolicy(3, MEMTABLE, UNIQUE)
    if name == "leveling":
        return mod.LevelingPolicy(3, MEMTABLE, UNIQUE)
    return mod.PartitionedLevelingPolicy(4, MEMTABLE, UNIQUE,
                                         file_entries=64, l1_capacity=256)


def _pair(policy: str, streaming: bool = True, scheduler: str = "fair"):
    ref = RefEngine(_policy(ref_pol, policy), ref_sched(scheduler),
                    memtable_entries=MEMTABLE, unique_keys=UNIQUE,
                    merge_block=BLOCK, streaming_merge=streaming,
                    backend="host")
    port = LSMEngine(_policy(pol, policy), make_scheduler(scheduler),
                     memtable_entries=MEMTABLE, unique_keys=UNIQUE,
                     merge_block=BLOCK, streaming_merge=streaming,
                     device="cpu")
    return ref, port


def _record_merges(eng) -> list:
    """Wrap the engine's merge finish to record every merge's output."""
    out = []
    orig = eng._finish_merge

    def finish(rm):
        if rm.buf_keys is not None:
            out.append((rm.buf_keys[:rm.emitted].copy(),
                        rm.buf_vals[:rm.emitted].copy()))
        elif rm.merged_keys is not None:
            out.append((np.asarray(rm.merged_keys).copy(),
                        np.asarray(rm.merged_vals).copy()))
        orig(rm)

    eng._finish_merge = finish
    return out


def _universe(rng) -> np.ndarray:
    return np.unique(rng.integers(0, 2**32 - 1, UNIQUE,
                                  dtype=np.uint64).astype(np.uint32))


def _same_reads(ref, port, universe, rng):
    q = rng.choice(universe, 300).astype(np.uint32)
    q[:5] = (0, 1, 2**31, 2**32 - 2, 2**31 - 1)      # absent/edge keys
    rf, rv = ref.get_batch(q)
    pf, pv = port.get_batch(q)
    assert np.array_equal(rf, pf) and np.array_equal(rv, pv)
    lo, hi = sorted(int(x) for x in rng.integers(0, 2**32, 2))
    for a, b in ((lo, hi), (0, 2**32)):
        rk, rv = ref.scan_range(a, b)
        pk, pv = port.scan_range(a, b)
        assert pk.dtype == np.uint32 and pv.dtype == np.int32
        assert np.array_equal(rk, pk) and np.array_equal(rv, pv)


def _drive(ref, port, seed: int, steps: int, universe):
    """One seeded workload through both engines, checking as it goes."""
    rng = np.random.default_rng(seed)
    quanta = (1, 7, 29, 53, 97, 129)
    for step in range(steps):
        n = int(rng.integers(1, 90))
        keys = rng.choice(universe, n).astype(np.uint32)
        if rng.random() < 0.15:
            assert ref.delete_batch(keys) == port.delete_batch(keys)
        else:
            vals = rng.integers(-2**31 + 1, 2**31, n).astype(np.int32)
            assert ref.put_batch(keys, vals) == port.put_batch(keys, vals)
        q = int(quanta[step % len(quanta)])
        assert ref.pump(q) == port.pump(q)
        if step % 15 == 0:
            _same_reads(ref, port, universe, rng)


def _layout(eng):
    return [(t.keys_np.tolist(), t.vals_np.tolist(), t.data_stamp,
             t.component.level) for t in eng._order]


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "oneshot"])
@pytest.mark.parametrize("policy", ["tiering", "leveling", "partitioned"])
def test_engine_replay_bit_identical(policy, streaming):
    ref, port = _pair(policy, streaming)
    ref_merges, port_merges = _record_merges(ref), _record_merges(port)
    universe = _universe(np.random.default_rng(1))
    _drive(ref, port, seed=2, steps=100, universe=universe)
    ref.drain(budget_entries=97)
    port.drain(budget_entries=97)
    _same_reads(ref, port, universe, np.random.default_rng(3))
    assert ref_merges, "workload produced no merges"
    assert len(ref_merges) == len(port_merges)
    for (rk, rv), (pk, pv) in zip(ref_merges, port_merges):
        assert np.array_equal(rk, pk) and np.array_equal(rv, pv)
    assert _layout(ref) == _layout(port)
    assert ref.stats == port.stats
    assert ref.num_components() == port.num_components()


@pytest.mark.parametrize("scheduler", ["greedy", "single"])
def test_engine_replay_schedulers(scheduler):
    ref, port = _pair("tiering", scheduler=scheduler)
    universe = _universe(np.random.default_rng(4))
    _drive(ref, port, seed=5, steps=80, universe=universe)
    assert ref.stats == port.stats
    assert _layout(ref) == _layout(port)


def test_compact_all_reclaims_tombstones():
    ref, port = _pair("leveling")
    universe = _universe(np.random.default_rng(6))
    _drive(ref, port, seed=7, steps=60, universe=universe)
    for eng in (ref, port):
        eng.delete_batch(universe[:500])
        eng.compact_all()
    assert ref.total_entries() == port.total_entries()
    assert ref.amplification() == port.amplification()
    assert ref.stats == port.stats
    _same_reads(ref, port, universe, np.random.default_rng(8))


def _state(ref) -> dict:
    """A reference engine's state as plain numpy arrays and numbers."""
    tree = ref.trees[0]
    index = {t.component.cid: i for i, t in enumerate(tree._order)}
    runs = [dict(keys=t.keys_np.copy(), vals=t.vals_np.copy(),
                 level=t.component.level, stamp=t.data_stamp,
                 created_at=t.component.created_at, size=t.component.size,
                 key_lo=t.component.key_lo, key_hi=t.component.key_hi)
            for t in tree._order]
    levels = {lvl: [index[c.cid] for c in comps]
              for lvl, comps in tree.meta.levels.items()}
    mem = lambda mt: (mt._keys[:len(mt)].copy(),  # noqa: E731
                      mt._vals[:len(mt)].copy())
    return {"runs": runs, "levels": levels, "stamp": tree._stamp,
            "now": ref.now, "active": mem(tree.active),
            "sealed": [mem(mt) for mt in tree.sealed]}


@pytest.mark.parametrize("policy", ["tiering", "leveling"])
def test_engine_from_numpy_mid_workload(policy):
    """State carried across mid-workload (running merges included): the
    port answers the same reads at once, holds the same runs in the same
    order, and after both engines take the same further writes and
    drain, the same data."""
    ref, _ = _pair(policy)
    universe = _universe(np.random.default_rng(9))
    rng = np.random.default_rng(10)
    for step in range(70):
        keys = rng.choice(universe, 40).astype(np.uint32)
        ref.put_batch(keys, rng.integers(0, 1 << 30, 40).astype(np.int32))
        ref.pump(31)
    assert ref.running, "expected merges in flight"
    port = engine_from_numpy(_state(ref), _policy(pol, policy),
                             make_scheduler("fair"),
                             memtable_entries=MEMTABLE, unique_keys=UNIQUE,
                             merge_block=BLOCK, device="cpu")
    assert _layout(ref) == _layout(port)
    assert [len(m) for m in ref.sealed] == [len(m) for m in port.sealed]
    assert {k: [c.size for c in v] for k, v in ref.tree.levels.items()
            if v} == \
        {k: [c.size for c in v] for k, v in port.tree.levels.items() if v}
    _same_reads(ref, port, universe, np.random.default_rng(11))
    for step in range(30):
        keys = rng.choice(universe, 40).astype(np.uint32)
        vals = rng.integers(0, 1 << 30, 40).astype(np.int32)
        for eng in (ref, port):
            done = 0
            while done < len(keys):       # every entry, in order
                done += eng.put_batch(keys[done:], vals[done:])
                eng.pump(31)
    ref.drain()
    port.drain()
    _same_reads(ref, port, universe, np.random.default_rng(12))
