"""Parity of the PyTorch port's storage kernels with the JAX reference,
on the CPU.

Inputs are made with numpy from fixed seeds and go through the reference
(``repro.kernels.{bloom,merge}`` — the numpy oracles, the host paths, and
the Pallas kernels in interpret mode at <= 2,048 entries) and through the
port's ops, which on CPU tensors run the kernels' plain PyTorch twins.
Keys cover the whole uint32 space (up to 2**32-2), so the unsigned order
of keys >= 2**31 is exercised everywhere; empty runs and empty windows
are included.

Tolerance: exact equality throughout (uint32 keys, int32 values and ages,
uint8/bool probe flags are compared bit for bit).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bloom import ops as ref_bloom_ops
from repro.kernels.bloom.ref import bloom_build_ref, bloom_probe_ref
from repro.kernels.merge import ops as ref_merge_ops
from repro.kernels.merge.merge import merge_path_merge_age as ref_merge_age
from repro.kernels.merge.ref import merge_dedup_kway_ref
from repro_torch.kernels.bloom import ops as bloom_ops
from repro_torch.kernels.bloom import ref as port_bloom_ref
from repro_torch.kernels.bloom.bloom import bloom_probe_multi_plain
from repro_torch.kernels.keys import keys_to_numpy, to_device
from repro_torch.kernels.merge import ops as merge_ops
from repro_torch.kernels.merge import ref as port_merge_ref
from repro_torch.kernels.merge.merge import merge_path_merge_age_plain

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _keys(rng, n: int, hi: int = 2**32 - 1) -> np.ndarray:
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _run(rng, n: int, hi: int = 2**32 - 1):
    ks = np.unique(_keys(rng, n, hi))
    vs = rng.integers(-2**31 + 1, 2**31, len(ks)).astype(np.int32)
    return ks, vs


def _dev(runs):
    return [(to_device(k, CPU), to_device(v, CPU)) for k, v in runs]


def _np(t_keys, t_vals):
    return keys_to_numpy(t_keys), t_vals.numpy()


# ---------------------------------------------------------------- bloom
@pytest.mark.parametrize("n", [0, 1, 100, 4095, 131072, 10**8])
@pytest.mark.parametrize("fpr", [0.001, 0.01, 0.3])
def test_filter_params_equal(n, fpr):
    assert bloom_ops.filter_params(n, fpr) == \
        ref_bloom_ops.filter_params(n, fpr)


@pytest.mark.parametrize("n,fpr", [(1, 0.01), (700, 0.01), (2048, 0.1),
                                   (3000, 0.001)])
def test_bloom_build_equal(n, fpr):
    rng = np.random.default_rng(n)
    keys = np.concatenate([_keys(rng, n), [0, 2**31, 2**32 - 2]]
                          ).astype(np.uint32)
    nb, kh = bloom_ops.filter_params(n, fpr)
    got = bloom_ops.bloom_build(to_device(keys, CPU), nb, kh)
    want = np.asarray(ref_bloom_ops.bloom_build(jnp.asarray(keys), nb, kh))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    bits = bloom_build_ref(keys, nb, kh)
    assert np.array_equal(port_bloom_ref.bloom_build_ref(keys, nb, kh), bits)


def _filter_stack(rng, sizes, fprs):
    filters, nbs, khs, tables = [], [], [], []
    for n, fpr in zip(sizes, fprs):
        keys = _keys(rng, n)
        nb, kh = bloom_ops.filter_params(n, fpr)
        filters.append(bloom_ops.bloom_build(to_device(keys, CPU), nb, kh))
        nbs.append(nb)
        khs.append(kh)
        tables.append(keys)
    filts, meta = bloom_ops.stack_filters(filters, nbs, khs, device=CPU)
    return filts, meta, tables


@pytest.mark.parametrize("seed", range(3))
def test_bloom_probe_multi_equal(seed):
    """Mixed geometries in one stack: the twin against the reference's
    host probe over the same words, the per-table numpy oracle, and (on
    the first seed) the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(1, 2000, 5)]
    filts, meta, tables = _filter_stack(rng, sizes,
                                        [0.01, 0.2, 0.001, 0.05, 0.01])
    q = np.concatenate([_keys(rng, 900), tables[0][:50], tables[3][:50]])
    q[:2] = (2**32 - 2, 2**31)
    got = bloom_ops.bloom_probe_multi(filts, meta, q)
    words = filts.numpy().view(np.uint32)
    assert np.array_equal(
        got, ref_bloom_ops.bloom_probe_multi_host(words, meta, q))
    for t, n in enumerate(sizes):
        bits = bloom_build_ref(tables[t], int(meta[t, 0]), int(meta[t, 1]))
        assert np.array_equal(got[t], bloom_probe_ref(
            bits, q, int(meta[t, 0]), int(meta[t, 1])))
    assert got[0][900:950].all() and got[3][950:1000].all()   # members
    if seed == 0:
        pallas = ref_bloom_ops.bloom_probe_multi(jnp.asarray(words), meta,
                                                 q, interpret=True)
        assert np.array_equal(got, pallas)


def test_bloom_probe_multi_empty():
    filts, meta, _ = _filter_stack(np.random.default_rng(0), [10], [0.01])
    assert bloom_ops.bloom_probe_multi(filts, meta,
                                       np.empty(0, np.uint32)).shape == (1, 0)
    assert bloom_probe_multi_plain(filts, meta, to_device(
        np.array([5], np.uint32), CPU)).dtype == torch.uint8


def test_set_stack_row_in_place():
    filts = torch.full((3, 8), 7, dtype=torch.int32)
    row = torch.tensor([1, -1, 3], dtype=torch.int32)
    out = bloom_ops.set_stack_row(filts, row, 1)
    assert out is filts
    assert filts[1].tolist() == [1, -1, 3, 0, 0, 0, 0, 0]
    assert filts[0].tolist() == [7] * 8 and filts[2].tolist() == [7] * 8


# ---------------------------------------------------------------- merge
def _aged(rng, n, hi, age):
    """A sorted run of unique keys, all of one age (the tournament's
    precondition: (key, age) pairs are distinct)."""
    ks, vs = _run(rng, n, hi)
    return ks, vs, np.full(len(ks), age, np.int32)


@pytest.mark.parametrize("na,nb,block,hi", [
    (100, 100, 64, 2**32 - 1), (1000, 37, 128, 300), (0, 64, 64, 2**32 - 1),
    (513, 511, 256, 2**32 - 1), (1, 0, 8, 10), (700, 900, 1, 50),
])
def test_merge_partitions_and_age_merge_equal(na, nb, block, hi):
    """Co-ranks on the padded runs, and the pairwise age merge, against
    the reference ops, the numpy oracle and the Pallas kernel."""
    rng = np.random.default_rng(na * 31 + nb)
    ka, va, aa = _aged(rng, na, hi, 0)
    kb, vb, ab = _aged(rng, nb, hi, 1)
    na, nb = len(ka), len(kb)
    t = [to_device(x, CPU) for x in (ka, va, aa, kb, vb, ab)]
    pa = merge_ops._pad_run_age(t[0], t[1], t[2], block)
    pb = merge_ops._pad_run_age(t[3], t[4], t[5], block)
    rpa = ref_merge_ops._pad_run_age(jnp.asarray(ka), jnp.asarray(va),
                                     jnp.asarray(aa), block)
    rpb = ref_merge_ops._pad_run_age(jnp.asarray(kb), jnp.asarray(vb),
                                     jnp.asarray(ab), block)
    for got, want in zip(pa + pb, rpa + rpb):
        assert np.array_equal(got.numpy(),
                              np.asarray(want).view(got.numpy().dtype))
    parts = merge_ops.merge_partitions(pa[0], pb[0], na, nb, block)
    want_parts = ref_merge_ops.merge_partitions(rpa[0], rpb[0], na, nb,
                                                block)
    assert np.array_equal(parts.numpy(), np.asarray(want_parts))
    mk, mv, ma, valid = merge_ops.merge_sorted_age(*t, block=block)
    assert valid == na + nb
    rk, rv, ra = port_merge_ref.merge_sorted_age_ref(ka, va, aa, kb, vb, ab)
    assert np.array_equal(keys_to_numpy(mk)[:valid], rk)
    assert np.array_equal(mv.numpy()[:valid], rv)
    assert np.array_equal(ma.numpy()[:valid], ra)
    assert (keys_to_numpy(mk)[valid:] == 0xFFFFFFFF).all()
    assert (ma.numpy()[valid:] == 2**31 - 1).all()
    if block >= 64 and na + nb <= 1100:      # the interpreter is slow
        pk, pv, pg = ref_merge_age(*rpa, *rpb, want_parts, block=block,
                                   interpret=True)
        assert np.array_equal(keys_to_numpy(mk), np.asarray(pk))
        assert np.array_equal(mv.numpy(), np.asarray(pv))
        assert np.array_equal(ma.numpy(), np.asarray(pg))


def test_age_merge_twin_tie_rule():
    """Equal keys in A and B: A's entries (smaller ages) come first, and
    the twin's per-block windows agree with the numpy lexsort."""
    ka = np.array([5, 5, 7, 2**31, 2**31 + 9], np.uint32)
    kb = np.array([5, 6, 2**31, 2**32 - 2], np.uint32)
    aa = np.array([0, 1, 0, 1, 0], np.int32)
    ab = np.array([2, 3, 2, 2], np.int32)
    va = np.arange(5, dtype=np.int32)
    vb = np.arange(10, 14, dtype=np.int32)
    order = np.lexsort((aa, ka))
    ka, va, aa = ka[order], va[order], aa[order]
    t = [to_device(x, CPU) for x in (ka, va, aa, kb, vb, ab)]
    for block in (1, 2, 4, 16):
        pa = merge_ops._pad_run_age(*t[:3], block)
        pb = merge_ops._pad_run_age(*t[3:], block)
        parts = merge_ops.merge_partitions(pa[0], pb[0], 5, 4, block)
        mk, mv, ma = merge_path_merge_age_plain(*pa, *pb, parts, block)
        rk, rv, ra = port_merge_ref.merge_sorted_age_ref(ka, va, aa,
                                                         kb, vb, ab)
        assert np.array_equal(keys_to_numpy(mk)[:9], rk)
        assert np.array_equal(mv.numpy()[:9], rv)
        assert np.array_equal(ma.numpy()[:9], ra)


def _kway_runs(rng, sizes, hi):
    return [_run(rng, n, hi) for n in sizes]


@pytest.mark.parametrize("sizes,block,hi", [
    ([300, 200, 100], 64, 2**32 - 1), ([50] * 8, 32, 400),
    ([0, 120, 0, 77, 1], 16, 2**32 - 1), ([900], 64, 2**32 - 1),
    ([], 64, 10), ([0, 0], 8, 10), ([1000, 1000, 500, 30, 7], 256, 3000),
])
@pytest.mark.parametrize("drop", [None, 0])
def test_merge_dedup_kway_equal(sizes, block, hi, drop):
    rng = np.random.default_rng(len(sizes) * 97 + block)
    runs = _kway_runs(rng, sizes, hi)
    if drop is not None:                         # some winners are drops
        for ks, vs in runs:
            vs[::3] = drop
    got = _np(*merge_ops.merge_dedup_kway(_dev(runs), block=block,
                                          drop_value=drop))
    rk, rv = merge_dedup_kway_ref(runs)
    if drop is not None:
        rk, rv = rk[rv != drop], rv[rv != drop]
    assert np.array_equal(got[0], rk) and np.array_equal(got[1], rv)
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int32
    assert np.array_equal(port_merge_ref.merge_dedup_kway_ref(runs)[0],
                          merge_dedup_kway_ref(runs)[0])


def test_merge_dedup_kway_equals_pallas_tournament():
    """The whole tournament against the reference's, Pallas in interpret
    mode, k=3 with drop_value (<= 2,048 entries)."""
    rng = np.random.default_rng(123)
    runs = _kway_runs(rng, [400, 300, 2], 2000)
    for ks, vs in runs:
        vs[::5] = -7
    got = _np(*merge_ops.merge_dedup_kway(_dev(runs), block=128,
                                          drop_value=-7))
    rk, rv = ref_merge_ops.merge_dedup_kway(
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in runs], block=64,
        interpret=True, drop_value=-7)
    assert np.array_equal(got[0], np.asarray(rk))
    assert np.array_equal(got[1], np.asarray(rv))


@pytest.mark.parametrize("seed", range(4))
def test_kway_windows_compose(seed):
    """Windows cut at global key boundaries (some empty) concatenate to
    the one-shot merge, and each equals the oracle's merge of the same
    windows."""
    rng = np.random.default_rng(seed)
    runs = _kway_runs(rng, [int(x) for x in rng.integers(0, 600, 4)],
                      2**32 - 1 if seed % 2 else 1500)
    dev = _dev(runs)
    cuts = np.sort(_keys(rng, 5, 2**32 - 1 if seed % 2 else 1500))
    bounds = [0, *cuts.tolist(), 2**32 - 1]
    parts_k, parts_v = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        starts = [int(np.searchsorted(k, np.uint32(lo))) for k, _ in runs]
        stops = [int(np.searchsorted(k, np.uint32(hi))) for k, _ in runs]
        wk, wv = _np(*merge_ops.merge_dedup_kway_window(
            dev, starts, stops, block=32, drop_value=None))
        want = merge_dedup_kway_ref([(k[s:e], v[s:e]) for (k, v), s, e
                                     in zip(runs, starts, stops)])
        assert np.array_equal(wk, want[0]) and np.array_equal(wv, want[1])
        parts_k.append(wk)
        parts_v.append(wv)
    whole = _np(*merge_ops.merge_dedup_kway(dev, block=32))
    assert np.array_equal(np.concatenate(parts_k), whole[0])
    assert np.array_equal(np.concatenate(parts_v), whole[1])
