"""Bloom filters over uint64 hashes, and the column hash of the bloom
file index.

Counterpart of paimon_tpu/index/bloom.py, reduced to `BloomFilter`
(the lookup SSTs' filter, lookup/sst.py; its serialized form is the
reference's byte for byte) and `hash_column`, which the cardinality
sketches of ops/sketch.py build on; the bloom file index is not ported
yet (ROADMAP.md: the remaining planes).
"""

from __future__ import annotations

import math
import struct

import numpy as np
import pyarrow as pa

__all__ = ["BloomFilter", "hash_column"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


class BloomFilter:
    """`k` probes of the double-hash sequence h1 + i * splitmix64(h1)
    over `bits` (uint64 words); native/probe.c replicates the probe."""

    def __init__(self, bits: np.ndarray, k: int):
        self.bits = bits
        self.k = k

    @property
    def num_bits(self) -> int:
        return len(self.bits) * 64

    @staticmethod
    def build(hashes: np.ndarray, fpp: float = 0.01) -> "BloomFilter":
        n = max(1, len(hashes))
        m = max(64, int(-n * math.log(fpp) / (math.log(2) ** 2)))
        m = ((m + 63) // 64) * 64
        k = max(1, round(m / n * math.log(2)))
        bits = np.zeros(m // 64, dtype=np.uint64)
        h2 = _splitmix64(hashes)
        for i in range(k):
            pos = (hashes + np.uint64(i) * h2) % np.uint64(m)
            np.bitwise_or.at(bits, (pos >> np.uint64(6)).astype(np.int64),
                             np.uint64(1) << (pos & np.uint64(63)))
        return BloomFilter(bits, k)

    def might_contain_many(self, hashes: np.ndarray) -> np.ndarray:
        """bool[n] for uint64 hashes[n], the probe sequence of build()."""
        m = np.uint64(self.num_bits)
        h1 = hashes.astype(np.uint64)
        h2 = _splitmix64(h1)
        out = np.ones(len(h1), dtype=bool)
        for i in range(self.k):
            pos = (h1 + np.uint64(i) * h2) % m
            words = self.bits[(pos >> np.uint64(6)).astype(np.int64)]
            out &= (words >> (pos & np.uint64(63))) & np.uint64(1) != 0
        return out

    def serialize(self) -> bytes:
        return struct.pack("<HI", self.k, len(self.bits)) + \
            self.bits.astype("<u8").tobytes()

    @staticmethod
    def deserialize(data: bytes) -> "BloomFilter":
        k, nwords = struct.unpack_from("<HI", data, 0)
        return BloomFilter(np.frombuffer(data, "<u8", nwords, 6).copy(), k)


def hash_column(col: pa.ChunkedArray) -> np.ndarray:
    """Stable uint64 hash per row (nulls hash to a sentinel that is
    never probed)."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    t = arr.type
    if pa.types.is_integer(t) or pa.types.is_temporal(t) or \
            pa.types.is_boolean(t):
        try:
            vals = np.asarray(arr.cast(pa.int64()).fill_null(0))
        except pa.ArrowNotImplementedError:
            vals = np.asarray(arr.cast(pa.int32()).fill_null(0)) \
                .astype(np.int64)
        return _splitmix64(vals.view(np.uint64))
    if pa.types.is_floating(t):
        vals = np.asarray(arr.cast(pa.float64()).fill_null(0.0))
        return _splitmix64(vals.view(np.uint64))
    if pa.types.is_string(t) or pa.types.is_large_string(t) or \
            pa.types.is_binary(t) or pa.types.is_large_binary(t):
        from paimon_tpu_torch.core.bucket import murmur_hash_bytes
        out = np.empty(len(arr), dtype=np.uint64)
        for i, v in enumerate(arr.to_pylist()):
            if v is None:
                out[i] = 0
                continue
            b = v.encode("utf-8") if isinstance(v, str) else v
            out[i] = np.uint64(murmur_hash_bytes(b)) | \
                (np.uint64(murmur_hash_bytes(b, seed=77)) << np.uint64(32))
        return out
    raise ValueError(f"bloom filter unsupported for type {t}")
