#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the LSM storage engine on one card and
check it end to end.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--records N]

Phases (any failure fails the run; nothing is caught and continued):

1. Build the CUDA kernels from ``src/repro_torch/csrc/`` (one ``nvcc``
   per source, in parallel).
2. Hold each kernel against its plain PyTorch twin on the card, bit for
   bit, at main-path shapes, and time kernel, twin, the least time the
   card could take (``bound``) and, where one exists, a library call
   computing the same function.
3. The main path at the paper's scale (Section 3.1: 128 MB memory
   components of 1 KB records = 131,072-entry memtables, 100M records):
   an ``LSMEngine`` on ``cuda`` under a tiering (size ratio 3) and a
   leveling (size ratio 10) policy ingests uniform uint32 keys with 10%
   overwrites and 1% deletes through ``put_batch``/``delete_batch``,
   pumping under a budget, drains, and answers 1M point reads and 16
   range scans, checked bit for bit against a numpy newest-wins oracle.
   Both kernels' launch counts over this phase must be positive.
4. The two-phase write-stall grid of ``benchmarks/twophase_engine.py``
   (3 policies x fair/greedy/single, virtual clock) on ``cuda`` and on
   ``cpu``: the numbers and verdicts must be identical.

The output ends with a ``{"kernels": [...]}`` line, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero without a result when no card is present.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.constraints import GlobalConstraint  # noqa: E402
from repro_torch.core.engine import (LSMEngine, LSMTree,  # noqa: E402
                                     _FilterStack)
from repro_torch.core.memtable import TOMBSTONE, MemTable  # noqa: E402
from repro_torch.core.policies import (LevelingPolicy,  # noqa: E402
                                       PartitionedLevelingPolicy,
                                       TieringPolicy)
from repro_torch.core.scheduler import make_scheduler  # noqa: E402
from repro_torch.core.sstable import SSTable  # noqa: E402
from repro_torch.core.twophase import EngineSystem, run_two_phase  # noqa
from repro_torch.kernels.bloom.bloom import (PROBE,  # noqa: E402
                                             bloom_probe_multi_cuda,
                                             bloom_probe_multi_plain)
from repro_torch.kernels.bloom.ops import (bloom_build,  # noqa: E402
                                          filter_params, stack_filters)
from repro_torch.kernels.cuda import build_all  # noqa: E402
from repro_torch.kernels.keys import (as_u64, keys_to_numpy,  # noqa: E402
                                      to_device)
from repro_torch.kernels.merge.merge import (MERGE,  # noqa: E402
                                             merge_path_merge_age_cuda,
                                             merge_path_merge_age_plain)
from repro_torch.kernels.merge.ops import (_pad_run_age,  # noqa: E402
                                           merge_dedup_kway,
                                           merge_dedup_kway_window,
                                           merge_partitions)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT_OPS_PER_S = 67e12            # 32-bit scalar rate outside the tensor
                                 # cores (the guide's float32 figure)
MEMTABLE = 131_072               # 128 MB of 1 KB records (paper, 3.1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean ms of ``fn`` on the card: CUDA events around ``reps`` calls
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class StageClock:
    """Host seconds spent inside chosen callables, by label: the script
    wraps them for one phase and puts the originals back after.  Calls
    that end in a copy to the host include the device work before it."""

    def __init__(self):
        self.acc: dict[str, float] = {}
        self._undo = []

    def wrap(self, owner, attr: str, label: str) -> None:
        orig = getattr(owner, attr)
        acc = self.acc

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0

        raw = owner.__dict__.get(attr) if isinstance(owner, type) else None
        self._undo.append((owner, attr, raw))
        setattr(owner, attr, timed)

    def take(self) -> dict[str, float]:
        out = dict(self.acc)
        self.acc.clear()
        return out

    def restore(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            if raw is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, raw)
        self._undo.clear()


def unique_keys(rng, n: int) -> np.ndarray:
    """``n`` distinct sorted uint32 keys over [0, 2**32-2)."""
    ks = np.unique(rng.integers(0, 2**32 - 2, int(n * 1.01) + 16,
                                dtype=np.uint32))
    return np.sort(rng.permutation(ks)[:n])


# ------------------------------------------------------------ phase 2
def check_probe(dev, rng) -> dict:
    """The fused probe at T=64 with mixed geometry: a 131,072-key row
    (staged in shared memory), rows too wide for shared memory (1M, 2M
    and 4M keys), and smaller rows at several FPRs; N = 65,536 keys."""
    sizes = [MEMTABLE, 1 << 20, 2 << 20, 4 << 20] + \
        [int(x) for x in rng.integers(1_000, MEMTABLE, 60)]
    fprs = [0.01, 0.01, 0.01, 0.01] + \
        [float(x) for x in rng.choice([0.001, 0.01, 0.05], 60)]
    filters, nbs, khs, members = [], [], [], None
    for n, fpr in zip(sizes, fprs):
        keys = unique_keys(rng, n)
        members = keys if members is None else members
        nb, kh = filter_params(n, fpr)
        filters.append(bloom_build(to_device(keys, dev), nb, kh))
        nbs.append(nb)
        khs.append(kh)
    filts, meta = stack_filters(filters, nbs, khs, device=dev)
    q = np.concatenate([rng.choice(members, 32_768),
                        rng.integers(0, 2**32 - 2, 32_768, dtype=np.uint32)])
    keys = to_device(q, dev)
    got = bloom_probe_multi_cuda(filts, meta, keys)
    want = bloom_probe_multi_plain(filts, meta, keys)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    require(torch.equal(got, want), "probe kernel != twin")
    require(bool(got[0, :32_768].all()), "probe: a member key was missed")
    t, n = int(meta.shape[0]), len(q)
    row_bytes = float(((meta[:, 0].astype(np.int64) + 31) // 32).sum() * 4)
    n_bytes = row_bytes + n * 4 + t * 8 + t * n
    # per key two hashes (~16 ops), per (row, key) and lane ~5 ops
    n_ops = n * 16 + float(n * meta[:, 1].astype(np.int64).sum() * 5)
    b, by = bound_ms(n_bytes, n_ops)
    res = {"name": "bloom_probe_multi", "route": "cuda",
           "source": "src/repro_torch/csrc/bloom_probe.cu",
           "replaces": "src/repro/kernels/bloom/bloom.py:71",
           "max_abs_err": err,
           "ms": cuda_ms(lambda: bloom_probe_multi_cuda(filts, meta, keys)),
           "plain_ms": cuda_ms(lambda: bloom_probe_multi_plain(filts, meta,
                                                                keys), 3),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "shape": f"T={t} N={n} widest row {int(filts.shape[1])} words"}
    log(f"probe: bit-identical to twin; kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    return res


def _pair_runs(rng, n: int):
    ka = unique_keys(rng, n)
    kb = np.unique(np.concatenate([rng.choice(ka, n // 2, replace=False),
                                   unique_keys(rng, n // 2)]))
    va = rng.integers(-2**31 + 1, 2**31, len(ka), dtype=np.int32)
    vb = rng.integers(-2**31 + 1, 2**31, len(kb), dtype=np.int32)
    return ka, va, kb, vb


def check_merge(dev, rng, block: int = 256) -> dict:
    """The age merge of two 4M-entry runs sharing half their keys, keys
    over the whole uint32 range (>= 2**31 included)."""
    n = 4 << 20
    ka, va, kb, vb = _pair_runs(rng, n)
    t = [to_device(x, dev) for x in (ka, va, kb, vb)]
    aa = torch.zeros(len(ka), dtype=torch.int32, device=dev)
    ab = torch.ones(len(kb), dtype=torch.int32, device=dev)
    pa = _pad_run_age(t[0], t[1], aa, block)
    pb = _pad_run_age(t[2], t[3], ab, block)
    parts = merge_partitions(pa[0], pb[0], len(ka), len(kb), block)
    got = merge_path_merge_age_cuda(*pa, *pb, parts, block)
    want = merge_path_merge_age_plain(*pa, *pb, parts, block)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "merge kernel != twin")
    valid = len(ka) + len(kb)
    mk = keys_to_numpy(got[0][:valid])
    require(bool((mk[1:] >= mk[:-1]).all()), "merge output not sorted")
    packed = (as_u64(torch.cat([t[0], t[2]])) << 32) | \
        torch.arange(valid, device=dev)
    g = int(parts.shape[0]) - 1
    n_bytes = valid * 12 + (g + 1) * 8 + g * block * 12
    n_ops = g * block * 4 * max(block, 1).bit_length()
    b, by = bound_ms(n_bytes, n_ops)
    res = {"name": "merge_path_merge_age", "route": "cuda",
           "source": "src/repro_torch/csrc/merge_path.cu",
           "replaces": "src/repro/kernels/merge/merge.py:157",
           "max_abs_err": err,
           "ms": cuda_ms(lambda: merge_path_merge_age_cuda(*pa, *pb, parts,
                                                           block)),
           "plain_ms": cuda_ms(lambda: merge_path_merge_age_plain(
               *pa, *pb, parts, block), 3),
           "bound_ms": b, "bound_by": by,
           "library_ms": cuda_ms(lambda: torch.sort(packed)),
           "shape": f"{len(ka)} + {len(kb)} entries, block {block}"}
    log(f"merge: bit-identical to twin; kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms, torch.sort yardstick "
        f"{res['library_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    return res


def newest_wins(keys: np.ndarray, vals: np.ndarray):
    """Numpy oracle: the last write of each key in log order, tombstoned
    keys dropped.  Returns sorted (keys, vals)."""
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order]
    last = np.ones(len(sk), bool)
    last[:-1] = sk[1:] != sk[:-1]
    sk, sv = sk[last], sv[last]
    live = sv != TOMBSTONE
    return sk[live], sv[live]


def check_kway(dev, rng) -> dict:
    """k=8 tournament with drop_value against the numpy oracle, and
    windows cut at key boundaries whose concatenation equals the one-shot
    merge."""
    runs = []
    universe = unique_keys(rng, 4 << 20)
    for _ in range(8):
        ks = np.sort(rng.choice(universe, 1 << 20, replace=False))
        vs = rng.integers(-2**31 + 1, 2**31, len(ks), dtype=np.int32)
        vs[rng.random(len(ks)) < 0.05] = TOMBSTONE
        runs.append((ks, vs))
    dev_runs = [(to_device(k, dev), to_device(v, dev)) for k, v in runs]
    dk, dv = merge_dedup_kway(dev_runs, block=256, drop_value=int(TOMBSTONE))
    # the log replays oldest first; run 0 is the newest
    wk, wv = newest_wins(np.concatenate([k for k, _ in runs[::-1]]),
                         np.concatenate([v for _, v in runs[::-1]]))
    require(np.array_equal(keys_to_numpy(dk), wk) and
            np.array_equal(dv.cpu().numpy(), wv), "k-way merge != oracle")
    cuts = [0, *np.sort(rng.integers(0, 2**32 - 2, 11)).tolist(),
            2**32 - 1]
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        starts = [int(np.searchsorted(k, np.uint32(lo))) for k, _ in runs]
        stops = [int(np.searchsorted(k, np.uint32(hi))) for k, _ in runs]
        parts.append(merge_dedup_kway_window(dev_runs, starts, stops,
                                             block=256,
                                             drop_value=int(TOMBSTONE)))
    require(torch.equal(torch.cat([p[0] for p in parts]), dk) and
            torch.equal(torch.cat([p[1] for p in parts]), dv),
            "windowed merges do not compose to the one-shot merge")
    allk = torch.cat([k for k, _ in dev_runs])
    packed = (as_u64(allk) << 32) | torch.arange(len(allk), device=dev)
    res = {"kway_ms": cuda_ms(lambda: merge_dedup_kway(
        dev_runs, block=256, drop_value=int(TOMBSTONE)), 3),
           "kway_sort_yardstick_ms": cuda_ms(lambda: torch.sort(packed)),
           "entries": int(len(allk)), "out": int(len(dk))}
    log(f"k-way (k=8, {res['entries']} entries, drop_value): equals the "
        f"oracle; windows compose; {res['kway_ms']:.3f} ms, torch.sort "
        f"yardstick {res['kway_sort_yardstick_ms']:.3f} ms")
    return res


# ------------------------------------------------------------ phase 3
def write_stream(records: int, batch: int, seed: int):
    """The ingest stream, batch by batch: uniform keys over
    [0, 2**32-2); 10% of writes overwrite a key written in an earlier
    batch and 1% delete one.  Yields (put_keys, put_vals, del_keys)."""
    rng = np.random.default_rng(seed)
    seen = np.empty(records, np.uint32)
    n_seen = 0
    done = 0
    while done < records:
        b = min(batch, records - done)
        keys = rng.integers(0, 2**32 - 2, b, dtype=np.uint32)
        kind = rng.random(b)
        if n_seen:
            old = kind < 0.11
            keys[old] = seen[rng.integers(0, n_seen, int(old.sum()))]
        dels = (kind >= 0.10) & (kind < 0.11) if n_seen else \
            np.zeros(b, bool)
        vals = rng.integers(0, 2**31 - 1, b, dtype=np.int32)
        seen[n_seen:n_seen + b] = keys
        n_seen += b
        done += b
        yield keys[~dels], vals[~dels], keys[dels]


def admit(eng, fn, keys, *vals, budget: int) -> None:
    """Admit every entry in order, pumping the background plane while
    the writer is stalled."""
    done = 0
    while done < len(keys):
        done += fn(keys[done:], *(v[done:] for v in vals))
        if done < len(keys):
            eng.pump(budget)


def main_path(dev, records: int, policy_name: str, seed: int = 7) -> dict:
    """One engine at the paper's memtable size over ``records`` writes;
    returns timings and checks every read against the oracle."""
    policy = TieringPolicy(3, MEMTABLE, records) if policy_name == \
        "tiering" else LevelingPolicy(10, MEMTABLE, records)
    eng = LSMEngine(policy, make_scheduler("fair"),
                    memtable_entries=MEMTABLE, unique_keys=records,
                    device=dev)
    budget = 8 * MEMTABLE
    clock = StageClock()
    for owner, attr, label in (
            (eng.backend, "merge_kway_window", "merge windows (device)"),
            (LSMTree, "_merge_cut", "merge cuts (host)"),
            (MemTable, "seal", "memtable sort (host)"),
            (SSTable, "build", "table build + upload"),
            (SSTable, "seal_checksum", "checksums (host)"),
            (_FilterStack, "sync", "filter build + stack (device)"),
            (eng.backend, "probe_multi", "probe (device + copies)"),
            (SSTable, "search", "table searches (host)"),
            (eng.backend, "scan_merge", "scan merges (device)")):
        clock.wrap(owner, attr, label)
    try:
        res = _drive_main_path(eng, dev, records, policy_name, seed, budget,
                               clock)
    finally:
        clock.restore()
    return res


def _drive_main_path(eng, dev, records, policy_name, seed, budget,
                     clock) -> dict:
    log_k, log_v = [], []
    sync(dev)
    t0 = time.perf_counter()
    for pk, pv, dk in write_stream(records, MEMTABLE, seed):
        admit(eng, eng.put_batch, pk, pv, budget=budget)
        admit(eng, eng.delete_batch, dk, budget=budget)
        eng.pump(budget)
        log_k += [pk, dk]
        log_v += [pv, np.full(len(dk), TOMBSTONE, np.int32)]
    eng.drain(budget)
    sync(dev)
    ingest_s = time.perf_counter() - t0
    stages = {"ingest": clock.take()}
    ok, ov = newest_wins(np.concatenate(log_k), np.concatenate(log_v))
    del log_k, log_v
    rng = np.random.default_rng(seed + 1)
    q = np.concatenate([rng.choice(ok, 500_000),
                        rng.integers(0, 2**32 - 2, 500_000,
                                     dtype=np.uint32)])
    t0 = time.perf_counter()
    found, vals = eng.get_batch(q)
    get_s = time.perf_counter() - t0
    stages["get_batch"] = clock.take()
    view = eng.trees[0]._read_view()
    q_dev = to_device(q, dev)
    counted = PROBE.launches       # timing launches are not the main path's
    probe_kernel_ms = cuda_ms(lambda: bloom_probe_multi_cuda(
        view.filts, view.meta, q_dev), 3) if dev.type == "cuda" else None
    PROBE.launches = counted
    pos = np.minimum(np.searchsorted(ok, q), len(ok) - 1)
    want_f = ok[pos] == q
    require(np.array_equal(found, want_f) and
            np.array_equal(vals, np.where(want_f, ov[pos], 0)),
            f"{policy_name}: get_batch != oracle")
    scan_s = []
    for lo in rng.integers(0, 2**32 - 2**22, 16):
        lo, hi = int(lo), int(lo) + 2**22
        t0 = time.perf_counter()
        sk, sv = eng.scan_range(lo, hi)
        scan_s.append(time.perf_counter() - t0)
        i, j = np.searchsorted(ok, [lo, hi])
        require(np.array_equal(sk, ok[i:j]) and np.array_equal(sv, ov[i:j]),
                f"{policy_name}: scan_range [{lo}, {hi}) != oracle")
    stages["scans"] = clock.take()
    live_bytes = sum(8 * len(t) for t in eng.tables.values())
    mem = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    require(dev.type != "cuda" or mem >= live_bytes,
            f"{policy_name}: device memory {mem} below the live tables' "
            f"{live_bytes} bytes")
    res = {"records": records, "live_keys": int(len(ok)),
           "ingest_s": ingest_s, "ingest_entries_per_s": records / ingest_s,
           "get_1m_s": get_s, "scan_mean_s": float(np.mean(scan_s)),
           "scan_max_s": float(np.max(scan_s)),
           "tables": len(eng.tables), "stats": eng.stats,
           "probe_kernel_ms": probe_kernel_ms, "stages_s": stages,
           "live_table_bytes": live_bytes, "memory_allocated": mem}
    log(f"main path [{policy_name}]: {records} records in {ingest_s:.1f} s "
        f"({res['ingest_entries_per_s']:.0f} entries/s), "
        f"{len(eng.tables)} tables; get_batch(1M) {get_s * 1e3:.1f} ms; "
        f"scan mean {res['scan_mean_s'] * 1e3:.1f} ms; all reads equal the "
        f"oracle; device memory {mem} >= live tables {live_bytes} bytes")
    for stage, parts in stages.items():
        log(f"  {stage}: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in parts.items()))
    log(f"  probe kernel alone on the 1M keys: {probe_kernel_ms} ms")
    return res


# ------------------------------------------------------------ phase 4
TP_MEMTABLE, TP_UNIQUE = 256, 1 << 14       # benchmarks/twophase_engine.py
TP_BANDWIDTH, TP_MEM_RATE = 4096 * 1024, 8000.0


def _tp_system(policy: str, scheduler: str, device: str) -> EngineSystem:
    def factory(dev):
        if policy == "tiering":
            p = TieringPolicy(3, TP_MEMTABLE, TP_UNIQUE)
        elif policy == "leveling":
            p = LevelingPolicy(3, TP_MEMTABLE, TP_UNIQUE)
        else:
            p = PartitionedLevelingPolicy(4, TP_MEMTABLE, TP_UNIQUE,
                                          file_entries=128, l1_capacity=512)
        return LSMEngine(p, make_scheduler(scheduler),
                         GlobalConstraint(2 * p.expected_components()),
                         memtable_entries=TP_MEMTABLE, unique_keys=TP_UNIQUE,
                         merge_block=64, device=dev)
    return EngineSystem(factory, bandwidth_bytes_per_s=TP_BANDWIDTH,
                        mem_write_rate=TP_MEM_RATE, tick_s=0.02,
                        device=device)


def twophase_grid(device: str, durations: dict) -> dict:
    grid = {}
    for pol in ("tiering", "leveling", "partitioned"):
        for sched in ("fair", "greedy", "single"):
            res = run_two_phase(
                testing_system=lambda: _tp_system(pol, "fair", device),
                running_system=lambda: _tp_system(pol, sched, device),
                **durations)
            cell = dict(res.summary())
            cell["testing_stalls"] = len(res.testing.stalls)
            cell["merges"] = res.running.merges_completed
            cell["processing"] = {str(k): v for k, v in
                                  res.processing_latencies.items()}
            grid[f"{pol}/{sched}"] = cell
    return grid


# ------------------------------------------------------------ driver
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=100_000_000,
                    help="records ingested per engine in phase 3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    t_start = time.perf_counter()
    report: dict = {"device": torch.cuda.get_device_name(0)}

    build_s = build_all([PROBE, MERGE])
    log(f"phase 1: built the CUDA kernels in {build_s:.1f} s")
    for k in (PROBE, MERGE):
        ptxas = [ln for ln in k.build_log.splitlines() if "registers" in ln
                 or "smem" in ln]
        log(f"  {k.source.name}: {' | '.join(ptxas)[:300]}")
    report["build_s"] = build_s

    rng = np.random.default_rng(0)
    kernels = [check_probe(dev, rng), check_merge(dev, rng)]
    report["kway"] = check_kway(dev, rng)
    log(f"phase 2: kernels bit-identical to their twins "
        f"(at {time.perf_counter() - t_start:.1f} s)")

    if args.records != 100_000_000:
        log(f"phase 3: records cut from 100,000,000 to {args.records:,}")
    PROBE.launches = MERGE.launches = 0
    report["main_path"] = {p: main_path(dev, args.records, p)
                           for p in ("tiering", "leveling")}
    launches = {"bloom_probe_multi": PROBE.launches,
                "merge_path_merge_age": MERGE.launches}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"phase 3: main path equal to the oracle; launches {launches} "
        f"(at {time.perf_counter() - t_start:.1f} s)")

    # the benchmark's full-mode durations
    durations = dict(testing_duration=12.0, running_duration=20.0,
                     warmup=2.0)
    t0 = time.perf_counter()
    PROBE.launches = MERGE.launches = 0
    gpu = twophase_grid("cuda", durations)
    gpu_launches = MERGE.launches
    t_gpu = time.perf_counter() - t0
    cpu = twophase_grid("cpu", durations)
    require(gpu == cpu, "two-phase grid differs between cuda and cpu")
    require(gpu_launches > 0, "the cuda grid never launched the merge")
    for name, cell in gpu.items():
        log(f"  {name}: max_tp {cell['max_throughput']:.1f} p99 "
            f"{cell['p99_write_latency']} stalls {cell['running_stalls']} "
            f"sustainable {cell['sustainable']}")
    log(f"phase 4: two-phase grid identical on cuda and cpu "
        f"(cuda {t_gpu:.1f} s, {gpu_launches} merge launches; at "
        f"{time.perf_counter() - t_start:.1f} s)")
    report["twophase"] = gpu
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    report["nvidia_smi"] = smi
    print("report: " + json.dumps(report, default=str))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: x[k] for k in keys}
                                  for x in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
