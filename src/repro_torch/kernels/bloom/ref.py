"""Oracle for the Bloom filter: an explicit numpy bit-set with the same
hash family (membership semantics verified independently of the packing
and kernel paths)."""
from __future__ import annotations

import numpy as np


def _hash_np(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.astype(np.uint32) ^ np.uint32(seed)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x45D9F3B)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x45D9F3B)
    return x ^ (x >> np.uint32(16))


def bit_positions_ref(keys: np.ndarray, n_bits: int, k_hashes: int) -> np.ndarray:
    h1 = _hash_np(keys, 0x9E3779B9)
    h2 = _hash_np(keys, 0x85EBCA6B) | np.uint32(1)
    i = np.arange(k_hashes, dtype=np.uint32)[:, None]
    return ((h1[None, :] + i * h2[None, :]) % np.uint32(n_bits)).astype(np.int64)


def bloom_build_ref(keys: np.ndarray, n_bits: int, k_hashes: int) -> np.ndarray:
    bits = np.zeros(n_bits, dtype=bool)
    bits[bit_positions_ref(np.asarray(keys), n_bits, k_hashes).reshape(-1)] = True
    return bits


def bloom_probe_ref(bits: np.ndarray, keys: np.ndarray, n_bits: int,
                    k_hashes: int) -> np.ndarray:
    pos = bit_positions_ref(np.asarray(keys), n_bits, k_hashes)
    return bits[pos].all(axis=0)
