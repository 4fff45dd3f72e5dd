"""RoaringBitmap32 wire codec (org.roaringbitmap portable format).

Copy of paimon_tpu/index/roaring.py (numpy only), for the rbm32/rbm64
aggregates of ops/agg.py.

reference: paimon-common/.../utils/RoaringBitmap32.java delegates to
org.roaringbitmap.RoaringBitmap.serialize/deserialize; the portable spec
(https://github.com/RoaringBitmap/RoaringFormatSpec) is:

little-endian; cookie 12346 (no run containers):
  [u32 cookie][u32 n_containers]
  n x [u16 key][u16 cardinality-1]
  n x [u32 byte offset of container from stream start]
  containers...
cookie low-16 == 12347 (has run containers): cookie high-16 = n-1,
  then a run-flag bitset of ceil(n/8) bytes, keys/cards, offsets only
  when n >= 4, containers.
Containers: array (sorted u16s) when cardinality <= 4096, else a 1024 x
u64 bitset; run containers are [u16 n_runs] + n_runs x [u16 start,
u16 length-1].

The codec works on numpy arrays of uint32 positions — vectorized
pack/unpack per container, no per-bit python loops.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

__all__ = ["serialize_roaring32", "deserialize_roaring32"]

SERIAL_COOKIE_NO_RUNCONTAINER = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4
ARRAY_MAX = 4096


def serialize_roaring32(positions: np.ndarray) -> bytes:
    """Serialize sorted unique uint32 positions (no run containers —
    always valid for any conforming reader)."""
    pos = np.unique(np.asarray(positions, dtype=np.uint64))
    if len(pos) and pos[-1] > 0xFFFFFFFF:
        raise ValueError(
            f"position {int(pos[-1])} exceeds the 32-bit roaring range "
            f"(reference BitmapDeletionVector rejects it too)")
    pos = pos.astype(np.uint32)
    keys = (pos >> np.uint32(16)).astype(np.uint16)
    lows = (pos & np.uint32(0xFFFF)).astype(np.uint16)
    uk, starts = np.unique(keys, return_index=True)
    n = len(uk)
    bounds = np.append(starts, len(pos))

    header = struct.pack("<II", SERIAL_COOKIE_NO_RUNCONTAINER, n)
    keycards = b"".join(
        struct.pack("<HH", int(uk[i]),
                    int(bounds[i + 1] - bounds[i] - 1))
        for i in range(n))
    containers: List[bytes] = []
    for i in range(n):
        vals = lows[bounds[i]:bounds[i + 1]]
        if len(vals) <= ARRAY_MAX:
            containers.append(vals.astype("<u2").tobytes())
        else:
            words = np.zeros(1024, dtype=np.uint64)
            v = vals.astype(np.uint32)
            np.bitwise_or.at(words, v >> np.uint32(6),
                             np.uint64(1) << (v & np.uint32(63)).astype(
                                 np.uint64))
            containers.append(words.astype("<u8").tobytes())
    offset0 = len(header) + len(keycards) + 4 * n
    offsets = []
    off = offset0
    for c in containers:
        offsets.append(off)
        off += len(c)
    offsets_b = b"".join(struct.pack("<I", o) for o in offsets)
    return header + keycards + offsets_b + b"".join(containers)


def deserialize_roaring32(data: bytes) -> np.ndarray:
    """-> sorted uint32 positions. Handles array, bitmap and run
    containers, both cookie layouts."""
    (cookie,) = struct.unpack_from("<I", data, 0)
    if (cookie & 0xFFFF) == SERIAL_COOKIE:
        n = (cookie >> 16) + 1
        has_run = True
        p = 4
        bitset_len = (n + 7) // 8
        run_flags = np.unpackbits(
            np.frombuffer(data, np.uint8, bitset_len, p),
            bitorder="little")[:n].astype(bool)
        p += bitset_len
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        (n,) = struct.unpack_from("<I", data, 4)
        has_run = False
        run_flags = np.zeros(n, dtype=bool)
        p = 8
    else:
        raise ValueError(f"Not a RoaringBitmap32 (cookie {cookie})")

    kc = np.frombuffer(data, "<u2", 2 * n, p).reshape(n, 2)
    keys = kc[:, 0].astype(np.uint32)
    cards = kc[:, 1].astype(np.int64) + 1
    p += 4 * n
    if not has_run or n >= NO_OFFSET_THRESHOLD:
        p += 4 * n          # offsets (containers follow sequentially)

    out: List[np.ndarray] = []
    for i in range(n):
        base = keys[i] << np.uint32(16)
        if run_flags[i]:
            (n_runs,) = struct.unpack_from("<H", data, p)
            p += 2
            runs = np.frombuffer(data, "<u2", 2 * n_runs, p) \
                .reshape(n_runs, 2).astype(np.int64)
            p += 4 * n_runs
            vals = np.concatenate([
                np.arange(s, s + ln + 1, dtype=np.uint32)
                for s, ln in runs]) if n_runs else \
                np.zeros(0, np.uint32)
        elif cards[i] <= ARRAY_MAX:
            vals = np.frombuffer(data, "<u2", int(cards[i]), p) \
                .astype(np.uint32)
            p += 2 * int(cards[i])
        else:
            words = np.frombuffer(data, "<u8", 1024, p)
            p += 8 * 1024
            bits = np.unpackbits(words.view(np.uint8),
                                 bitorder="little")
            vals = np.flatnonzero(bits).astype(np.uint32)
        out.append(base | vals)
    if not out:
        return np.zeros(0, dtype=np.uint32)
    return np.concatenate(out)


def serialize_roaring64(positions: "np.ndarray") -> bytes:
    """RoaringBitmap64 portable wire format (reference
    utils/RoaringBitmap64.java -> Roaring64NavigableMap portable
    serialization): u64 LE bucket count, then per bucket the u32 high
    word + the bucket's roaring32 bytes, highs ascending."""
    positions = np.asarray(positions, dtype=np.uint64)
    positions = np.unique(positions)
    highs = (positions >> np.uint64(32)).astype(np.uint32)
    lows = (positions & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    parts = [struct.pack("<Q", len(np.unique(highs)))]
    for h in np.unique(highs):
        sel = highs == h
        parts.append(struct.pack("<I", int(h)))
        parts.append(serialize_roaring32(lows[sel]))
    return b"".join(parts)


def deserialize_roaring64(data: bytes) -> "np.ndarray":
    mv = memoryview(data)
    (n,) = struct.unpack_from("<Q", data, 0)
    p = 8
    out: List[np.ndarray] = []
    for _ in range(n):
        (high,) = struct.unpack_from("<I", data, p)
        p += 4
        end = p + _roaring32_size(data, p)
        # memoryview slice: no tail copy per bucket
        lows = deserialize_roaring32(mv[p:end])
        p = end
        out.append((np.uint64(high) << np.uint64(32))
                   | lows.astype(np.uint64))
    if not out:
        return np.zeros(0, dtype=np.uint64)
    return np.concatenate(out)


def _roaring32_size(data: bytes, off: int) -> int:
    """Byte length of the roaring32 stream starting at `off` (needed
    when streams are concatenated, as in roaring64); computed from the
    header + per-container cardinalities without copying the payload."""
    (cookie,) = struct.unpack_from("<I", data, off)
    if (cookie & 0xFFFF) == SERIAL_COOKIE:
        n = (cookie >> 16) + 1
        p = off + 4 + (n + 7) // 8
        has_offsets = n >= NO_OFFSET_THRESHOLD
        flags = np.frombuffer(data, np.uint8, (n + 7) // 8, off + 4)
        run_flags = np.unpackbits(flags, bitorder="little")[:n]
    elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
        (n,) = struct.unpack_from("<I", data, off + 4)
        p = off + 8
        has_offsets = True
        run_flags = None
    else:
        raise ValueError(f"bad roaring cookie {cookie}")
    keys_cards = np.frombuffer(data, "<u2", 2 * n, p).reshape(n, 2)
    p += 4 * n
    if has_offsets:
        p += 4 * n
    end = p
    for i in range(n):
        card = int(keys_cards[i, 1]) + 1
        if run_flags is not None and run_flags[i]:
            (n_runs,) = struct.unpack_from("<H", data, end)
            end += 2 + 4 * n_runs
        elif card <= ARRAY_MAX:
            end += 2 * card
        else:
            end += 8 * 1024
    return end - off
