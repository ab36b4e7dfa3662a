"""Parity of the PyTorch port's two-phase write-stall harness with the JAX
reference, on the CPU.

``benchmarks/twophase_engine.py``'s deterministic grid — its constants
(memtable 256, 2**14 unique keys, 4096 entries/s of background I/O,
8000 entries/s of insert capacity, merge block 64), three policies x
fair/greedy/single, the virtual clock — at reduced durations, through
the reference ``run_two_phase``/``EngineSystem`` (engines on the host
backend) and through the port's (engines on ``device="cpu"``).

Tolerance: exact equality — every ``TwoPhaseResult`` number (max
throughput, arrival rate, write and processing latency percentiles,
stall counts and times, merges) and every verdict.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks.twophase_engine import (BANDWIDTH, MEM_RATE, MEMTABLE,
                                        UNIQUE)
from repro.core import constraints as ref_cons
from repro.core import policies as ref_pol
from repro.core.engine import LSMEngine as RefEngine
from repro.core.scheduler import make_scheduler as ref_sched
from repro.core.twophase import EngineSystem as RefSystem
from repro.core.twophase import run_two_phase as ref_run
from repro_torch.core import constraints as cons
from repro_torch.core import policies as pol
from repro_torch.core.engine import LSMEngine
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.twophase import EngineSystem, run_two_phase

torch.set_num_threads(1)

DURATIONS = dict(testing_duration=4.0, running_duration=5.0, warmup=1.0)


def _policy(mod, name: str):
    if name == "tiering":
        return mod.TieringPolicy(3, MEMTABLE, UNIQUE)
    if name == "leveling":
        return mod.LevelingPolicy(3, MEMTABLE, UNIQUE)
    return mod.PartitionedLevelingPolicy(4, MEMTABLE, UNIQUE,
                                         file_entries=128, l1_capacity=512)


def _ref_system(policy: str, scheduler: str) -> RefSystem:
    def factory():
        p = _policy(ref_pol, policy)
        return RefEngine(p, ref_sched(scheduler),
                         ref_cons.GlobalConstraint(2 * p.expected_components()),
                         memtable_entries=MEMTABLE, unique_keys=UNIQUE,
                         merge_block=64, backend="host")
    return RefSystem(factory, bandwidth_bytes_per_s=BANDWIDTH,
                     mem_write_rate=MEM_RATE, tick_s=0.02)


def _port_system(policy: str, scheduler: str) -> EngineSystem:
    def factory(device):
        p = _policy(pol, policy)
        return LSMEngine(p, make_scheduler(scheduler),
                         cons.GlobalConstraint(2 * p.expected_components()),
                         memtable_entries=MEMTABLE, unique_keys=UNIQUE,
                         merge_block=64, device=device)
    return EngineSystem(factory, bandwidth_bytes_per_s=BANDWIDTH,
                        mem_write_rate=MEM_RATE, tick_s=0.02, device="cpu")


def _numbers(res) -> dict:
    return {"max_throughput": res.max_throughput,
            "arrival_rate": res.arrival_rate,
            "write": res.write_latencies,
            "processing": res.processing_latencies,
            "running_stalls": res.running.stalls,
            "running_stall_time": res.running.stall_time(),
            "testing_stalls": res.testing.stalls,
            "merges": res.running.merges_completed,
            "components": res.running.max_components(),
            "summary": res.summary()}


@pytest.mark.parametrize("scheduler", ["fair", "greedy", "single"])
@pytest.mark.parametrize("policy", ["tiering", "leveling", "partitioned"])
def test_twophase_grid_cell_identical(policy, scheduler):
    ref = ref_run(testing_system=lambda: _ref_system(policy, "fair"),
                  running_system=lambda: _ref_system(policy, scheduler),
                  **DURATIONS)
    port = run_two_phase(testing_system=lambda: _port_system(policy, "fair"),
                         running_system=lambda: _port_system(policy,
                                                             scheduler),
                         **DURATIONS)
    assert _numbers(port) == _numbers(ref)
    assert port.sustainable == ref.sustainable
    assert np.array_equal(port.running.arrival_t, ref.running.arrival_t)


def test_realtime_driver_smoke():
    """Wall-clock pacing through the port's ``BackgroundDriver``: a short
    real-time two-phase run completes with well-formed metrics (timings
    differ run to run, so this one is not compared with the reference)."""
    def mk():
        s = _port_system("tiering", "greedy")
        s.realtime, s.tick_s = True, 0.005
        return s
    res = run_two_phase(testing_system=mk, testing_duration=0.6,
                        running_duration=0.8, warmup=0.1)
    assert res.max_throughput > 0
    assert np.isfinite(res.write_latencies[99])
    for s0, s1 in res.running.stalls:
        assert 0.0 <= s0 <= s1 <= res.running.duration


def test_engine_system_defaults_to_the_card():
    system = EngineSystem(lambda device: None, bandwidth_bytes_per_s=1.0)
    assert str(system.device) == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            system.run(None, 1.0)
