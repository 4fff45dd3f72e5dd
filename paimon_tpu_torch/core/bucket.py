"""Bucket assignment.

reference: paimon-common/.../utils/MurmurHashUtils + table/sink/
KeyAndBucketExtractor: bucket = abs(javaRem(murmur32_words(binaryRow bytes
without arity prefix, seed=42), numBuckets)). Matching the reference hash
bit-for-bit keeps our data files bucket-compatible with JVM/pypaimon
readers and writers.

The hash is vectorized over rows with numpy when the bucket key serializes
to fixed-width BinaryRows (int/float/date keys); variable-width keys fall
back to a per-row loop.
"""

from __future__ import annotations

import struct
from typing import Any, List, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.data.binary_row import BinaryRowCodec
from paimon_tpu_torch.types import (
    BigIntType, BooleanType, DataType, DateType, DoubleType, FloatType,
    IntType, SmallIntType, TimeType, TinyIntType,
)

__all__ = ["murmur_hash_bytes", "KeyHasher", "FixedBucketAssigner",
           "bucket_of"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED = 42
_M32 = 0xFFFFFFFF


def murmur_hash_bytes(data: bytes, seed: int = _SEED) -> int:
    """Murmur3-style word hash over complete 4-byte words (tail bytes
    ignored, matching the reference's hashBytesByWords)."""
    n = len(data)
    h1 = seed
    for i in range(0, n - (n % 4), 4):
        k1 = struct.unpack_from("<I", data, i)[0]
        k1 = (k1 * _C1) & _M32
        k1 = ((k1 << 15) | (k1 >> 17)) & _M32
        k1 = (k1 * _C2) & _M32
        h1 = (h1 ^ k1) & _M32
        h1 = ((h1 << 13) | (h1 >> 19)) & _M32
        h1 = (h1 * 5 + 0xE6546B64) & _M32
    return _fmix(h1, n)


def _fmix(h1: int, length: int) -> int:
    h1 = (h1 ^ length) & _M32
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    h1 ^= h1 >> 16
    return h1


def _bucket_from_hash(h: np.ndarray, num_buckets: int) -> np.ndarray:
    """Java `Math.abs(h % n)` with truncated division, vectorized."""
    signed = h.astype(np.int64)
    signed = np.where(signed >= 1 << 31, signed - (1 << 32), signed)
    rem = signed - np.trunc(signed / num_buckets).astype(np.int64) \
        * num_buckets
    return np.abs(rem).astype(np.int32)


def bucket_of(values: Sequence[Any], types: Sequence[DataType],
              num_buckets: int) -> int:
    codec = BinaryRowCodec(types)
    data = codec.to_bytes(values, with_arity_prefix=False)
    h = murmur_hash_bytes(data)
    return int(_bucket_from_hash(np.array([h], dtype=np.uint64),
                                 num_buckets)[0])


_HASH_SLICE_ROWS = 1 << 20

_FIXED_SLOT_TYPES = (BooleanType, TinyIntType, SmallIntType, IntType,
                     BigIntType, FloatType, DoubleType, DateType, TimeType)


class KeyHasher:
    """Vectorized reference-compatible murmur hash of bucket-key rows
    (the shared base of fixed and dynamic bucket assignment)."""

    def __init__(self, bucket_key_names: Sequence[str],
                 bucket_key_types: Sequence[DataType]):
        self.names = list(bucket_key_names)
        self.types = list(bucket_key_types)
        self._codec = BinaryRowCodec(self.types)
        self._fixed_width = all(isinstance(t, _FIXED_SLOT_TYPES)
                                for t in self.types)

    def hashes(self, table: pa.Table) -> np.ndarray:
        """uint64[N] murmur hashes (low 32 bits significant)."""
        # the numpy path's fixed setup (byte matrix + casts) costs more
        # than row-at-a-time hashing below ~10 rows — point-lookup
        # batches take the scalar codec path, ingest batches the
        # vectorized one; both produce identical reference hashes
        if self._fixed_width and table.num_rows > 8:
            # in slices: the byte matrix and its temporaries of a slice
            # stay cache-sized however long the batch
            step = _HASH_SLICE_ROWS
            if table.num_rows <= step:
                return self._hash_vectorized(table)
            return np.concatenate([
                self._hash_vectorized(table.slice(i, step))
                for i in range(0, table.num_rows, step)])
        return self._hash_rows(table)

    def _hash_rows(self, table: pa.Table) -> np.ndarray:
        cols = [table.column(n).to_pylist() for n in self.names]
        out = np.empty(table.num_rows, dtype=np.uint64)
        for i in range(table.num_rows):
            values = tuple(c[i] for c in cols)
            data = self._codec.to_bytes(values, with_arity_prefix=False)
            out[i] = murmur_hash_bytes(data)
        return out

    def _hash_vectorized(self, table: pa.Table) -> np.ndarray:
        """Build the BinaryRow byte matrix for all rows at once, then run
        murmur word-mixing across rows with numpy."""
        n = table.num_rows
        arity = len(self.types)
        null_bytes = ((arity + 63 + 8) // 64) * 8
        row_len = null_bytes + arity * 8
        mat = np.zeros((n, row_len), dtype=np.uint8)
        for i, (name, t) in enumerate(zip(self.names, self.types)):
            col = table.column(name).combine_chunks()
            null_mask = np.asarray(col.is_null())
            slot = null_bytes + i * 8
            if isinstance(t, (BooleanType,)):
                vals = np.asarray(col.cast(pa.int8()).fill_null(0))
                mat[:, slot] = vals.astype(np.uint8)
            elif isinstance(t, TinyIntType):
                v = np.asarray(col.fill_null(0)).astype(np.int8)
                mat[:, slot:slot + 1] = v.view(np.uint8)[:, None]
            elif isinstance(t, SmallIntType):
                v = np.asarray(col.fill_null(0)).astype("<i2")
                mat[:, slot:slot + 2] = v.view(np.uint8).reshape(n, 2)
            elif isinstance(t, (IntType, DateType, TimeType)):
                v = np.asarray(col.cast(pa.int32()).fill_null(0)) \
                    .astype("<i4")
                mat[:, slot:slot + 4] = v.view(np.uint8).reshape(n, 4)
            elif isinstance(t, BigIntType):
                v = np.asarray(col.cast(pa.int64()).fill_null(0)) \
                    .astype("<i8")
                mat[:, slot:slot + 8] = v.view(np.uint8).reshape(n, 8)
            elif isinstance(t, FloatType):
                v = np.asarray(col.fill_null(0)).astype("<f4")
                mat[:, slot:slot + 4] = v.view(np.uint8).reshape(n, 4)
            elif isinstance(t, DoubleType):
                v = np.asarray(col.fill_null(0)).astype("<f8")
                mat[:, slot:slot + 8] = v.view(np.uint8).reshape(n, 8)
            if null_mask.any():
                idx = i + 8
                mat[null_mask, idx // 8] |= np.uint8(1 << (idx % 8))
                mat[null_mask, slot:slot + 8] = 0
        return self._murmur_rows(mat)

    def _murmur_rows(self, mat: np.ndarray) -> np.ndarray:
        """Murmur3 of each row of `mat` in uint32 arithmetic, which wraps
        modulo 2^32 as the masked uint64 steps of `murmur_hash_bytes`
        do; the hashes widened to uint64."""
        n, row_len = mat.shape
        if n == 0:
            return np.empty(0, dtype=np.uint64)
        words = np.ascontiguousarray(
            mat[:, :row_len - (row_len % 4)]).view("<u4")
        h1 = np.full(n, _SEED, dtype=np.uint32)
        c1, c2 = np.uint32(_C1), np.uint32(_C2)
        with np.errstate(over="ignore"):
            for w in range(words.shape[1]):
                k1 = words[:, w] * c1
                k1 = (k1 << np.uint32(15)) | (k1 >> np.uint32(17))
                k1 *= c2
                h1 ^= k1
                h1 = (h1 << np.uint32(13)) | (h1 >> np.uint32(19))
                h1 = h1 * np.uint32(5) + np.uint32(0xE6546B64)
            h1 ^= np.uint32(row_len)
            h1 ^= h1 >> np.uint32(16)
            h1 *= np.uint32(0x85EBCA6B)
            h1 ^= h1 >> np.uint32(13)
            h1 *= np.uint32(0xC2B2AE35)
            h1 ^= h1 >> np.uint32(16)
        return h1.astype(np.uint64)


class FixedBucketAssigner:
    """Vectorized fixed-bucket assignment for Arrow batches."""

    def __init__(self, bucket_key_names: Sequence[str],
                 bucket_key_types: Sequence[DataType], num_buckets: int):
        if num_buckets <= 0:
            raise ValueError(f"bucket must be > 0, got {num_buckets}")
        self.names = list(bucket_key_names)
        self.types = list(bucket_key_types)
        self.num_buckets = num_buckets
        self._hasher = KeyHasher(bucket_key_names, bucket_key_types)

    def assign(self, table: pa.Table) -> np.ndarray:
        return _bucket_from_hash(self._hasher.hashes(table),
                                 self.num_buckets)
