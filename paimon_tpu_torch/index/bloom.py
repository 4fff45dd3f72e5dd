"""Per-file bloom filter indexes.

Counterpart of paimon_tpu/index/bloom.py: `BloomFilter` (also the lookup
SSTs' filter, lookup/sst.py), the column hash (`hash_column`, which the
cardinality sketches of ops/sketch.py build on too, and `hash_value` for
one literal; strings and binaries hash as core/bucket.py's word hash,
computed for the whole column at once), the v1 bloom-only file-index
blob (`build_file_index`, `read_file_index`) and the placement of a
file's index blob: embedded in the manifest entry up to
file-index.in-manifest-threshold, else a `<data-file>.index` sidecar
(`place_file_index`).  Every serialized form is the reference's byte
for byte.

reference: paimon-common/.../fileindex/bloomfilter/ (BloomFilterFileIndex
+ FastHash), io/DataFileIndexWriter (placement).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa

__all__ = ["BloomFilter", "build_file_index", "place_file_index",
           "read_file_index", "hash_column", "hash_value"]

_MAGIC = b"PTFI"          # file index blob
_VERSION = 1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


_U64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64_int(x: int) -> int:
    """_splitmix64 of one value, in Python integers."""
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


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
        # bit p of the filter is bit p % 64 of word p // 64: one flag
        # per bit, packed little-endian, gives those words
        flags = np.zeros(m, dtype=bool)
        h2 = _splitmix64(hashes)
        for i in range(k):
            flags[(hashes + np.uint64(i) * h2) % np.uint64(m)] = True
        bits = np.packbits(flags, bitorder="little").view("<u8") \
            .astype(np.uint64)
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

    def might_contain(self, h: int) -> bool:
        """One hash, the probe sequence of build()."""
        m = self.num_bits
        h1 = int(h) & _U64
        h2 = _splitmix64_int(h1)
        for i in range(self.k):
            pos = (h1 + i * h2) % (1 << 64) % m
            if not (int(self.bits[pos >> 6]) >> (pos & 63)) & 1:
                return False
        return True

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
        return _hash_binary(arr.cast(pa.large_binary()))
    raise ValueError(f"bloom filter unsupported for type {t}")


_M32 = np.uint64(0xFFFFFFFF)


def _murmur_words(data: np.ndarray, starts: np.ndarray,
                  lengths: np.ndarray, seed: int) -> np.ndarray:
    """core/bucket.py `murmur_hash_bytes` of every row's bytes at once:
    the same word hash over complete 4-byte words (tail bytes ignored),
    one pass per word position over the rows that still have words."""
    n = len(starts)
    h = np.full(n, seed, dtype=np.uint64)
    words = lengths // 4
    rows = np.arange(n)
    for j in range(int(words.max()) if n else 0):
        rows = rows[words[rows] > j]
        at = starts[rows] + 4 * j
        k = (data[at].astype(np.uint64)
             | (data[at + 1].astype(np.uint64) << np.uint64(8))
             | (data[at + 2].astype(np.uint64) << np.uint64(16))
             | (data[at + 3].astype(np.uint64) << np.uint64(24)))
        k = (k * np.uint64(0xCC9E2D51)) & _M32
        k = ((k << np.uint64(15)) | (k >> np.uint64(17))) & _M32
        k = (k * np.uint64(0x1B873593)) & _M32
        hr = h[rows] ^ k
        hr = ((hr << np.uint64(13)) | (hr >> np.uint64(19))) & _M32
        h[rows] = (hr * np.uint64(5) + np.uint64(0xE6546B64)) & _M32
    h ^= lengths.astype(np.uint64) & _M32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    return h ^ (h >> np.uint64(16))


def _hash_binary(arr: pa.Array) -> np.ndarray:
    """Strings and binaries (as large_binary): the word hash with seed
    42 in the low half and seed 77 in the high half; null rows hash to
    0."""
    n = len(arr)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    bufs = arr.buffers()
    offsets = np.frombuffer(bufs[1], dtype=np.int64, count=n + 1,
                            offset=arr.offset * 8)
    data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None \
        else np.zeros(0, dtype=np.uint8)
    starts = offsets[:-1]
    lengths = offsets[1:] - starts
    out = _murmur_words(data, starts, lengths, 42) | \
        (_murmur_words(data, starts, lengths, 77) << np.uint64(32))
    if arr.null_count:
        out[np.asarray(arr.is_null())] = 0
    return out


def hash_value(value, arrow_type: pa.DataType) -> int:
    """Hash one literal as hash_column hashes its column."""
    return int(hash_column(pa.chunked_array(
        [pa.array([value], arrow_type)]))[0])


def build_file_index(table: pa.Table, columns: List[str],
                     fpp: float = 0.01) -> Optional[bytes]:
    """The v1 blob: one bloom filter per column, bloom only."""
    entries = []
    for c in columns:
        if c not in table.column_names:
            continue
        try:
            hashes = hash_column(table.column(c))
        except ValueError:
            continue
        blob = BloomFilter.build(hashes, fpp).serialize()
        cname = c.encode("utf-8")
        entries.append(struct.pack("<HI", len(cname), len(blob))
                       + cname + blob)
    if not entries:
        return None
    return _MAGIC + bytes([_VERSION]) + b"".join(entries)


def place_file_index(file_io, path_factory, partition, bucket,
                     data_file_name: str, blob: Optional[bytes],
                     threshold: int):
    """-> (embedded_index, extra_files): a blob up to `threshold` bytes
    embeds in the manifest entry, a larger one becomes the
    `<data-file>.index` sidecar."""
    if blob is None:
        return None, []
    if len(blob) <= threshold:
        return blob, []
    sidecar = data_file_name + ".index"
    file_io.write_bytes(
        path_factory.data_file_path(partition, bucket, sidecar), blob,
        overwrite=False)
    return None, [sidecar]


def read_file_index(data: Optional[bytes]) -> Dict[str, BloomFilter]:
    """column -> BloomFilter of a v1 blob ({} for anything else)."""
    if not data or data[:4] != _MAGIC:
        return {}
    out: Dict[str, BloomFilter] = {}
    p = 5
    while p < len(data):
        nlen, blen = struct.unpack_from("<HI", data, p)
        p += 6
        name = data[p:p + nlen].decode("utf-8")
        p += nlen
        out[name] = BloomFilter.deserialize(data[p:p + blen])
        p += blen
    return out
