"""Mergeable cardinality sketches: HyperLogLog and theta (KMV).

Copy of paimon_tpu/ops/sketch.py, for the hll_sketch/theta_sketch
aggregates of ops/agg.py; same wire format.

reference: mergetree/compact/aggregate/FieldHllSketchAgg.java and
FieldThetaSketchAgg.java merge pre-built Apache DataSketches blobs.
That library is JVM-only, so these are from-scratch sketches with the
same aggregation contract (binary column in -> merged binary out,
commutative + idempotent union) under a tagged wire format of our own:

  HLL:   "PTHL" u8 p, then 2^p registers (one byte each).  Union is an
         elementwise max — one vectorized np.maximum.
  theta: "PTTH" u16 k, u32 n, then n<=k sorted u64 hashes (the K
         minimum values construction).  Union merges + keeps the k
         smallest; the estimate is (n-1) / theta where theta is the
         k-th smallest hash normalized to (0,1].

Builders hash with splitmix64 (shared with the bloom index), whole
column at a time.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.index.bloom import hash_column

__all__ = ["hll_build", "hll_union", "hll_estimate",
           "theta_build", "theta_union", "theta_estimate"]

_HLL_MAGIC = b"PTHL"
_THETA_MAGIC = b"PTTH"
_DEFAULT_P = 12
_DEFAULT_K = 4096


# -- HyperLogLog -------------------------------------------------------------

def hll_build(col, p: int = _DEFAULT_P) -> bytes:
    """Sketch a column's values (nulls skipped)."""
    arr = col if isinstance(col, pa.ChunkedArray) else pa.chunked_array(
        [col])
    import pyarrow.compute as pc
    arr = arr.filter(pc.is_valid(arr))
    m = 1 << p
    regs = np.zeros(m, dtype=np.uint8)
    if len(arr):
        h = hash_column(arr)
        idx = (h >> np.uint64(64 - p)).astype(np.int64)
        rest = (h << np.uint64(p)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        rank = np.minimum(_clz64(rest) + 1, 64 - p + 1).astype(np.uint8)
        np.maximum.at(regs, idx, rank)
    return _HLL_MAGIC + bytes([p]) + regs.tobytes()


def _clz64(x: np.ndarray) -> np.ndarray:
    """Exact vectorized count-leading-zeros (6 binary steps)."""
    x = x.astype(np.uint64)
    msb = np.zeros(x.shape, np.int64)     # floor(log2(x)) for x > 0
    cur = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        big = cur >= (np.uint64(1) << np.uint64(s))
        msb = np.where(big, msb + s, msb)
        cur = np.where(big, cur >> np.uint64(s), cur)
    return np.where(x == 0, 64, 63 - msb).astype(np.int64)


def _hll_regs(blob: bytes):
    if blob[:4] != _HLL_MAGIC:
        raise ValueError("not a PTHL sketch")
    p = blob[4]
    return p, np.frombuffer(blob, np.uint8, 1 << p, 5)


def hll_union(blobs: Iterable[bytes]) -> Optional[bytes]:
    acc = None
    p0 = None
    for b in blobs:
        if b is None:
            continue
        p, regs = _hll_regs(bytes(b))
        if acc is None:
            acc, p0 = regs.copy(), p
        else:
            if p != p0:
                raise ValueError("mismatched HLL precisions")
            acc = np.maximum(acc, regs)
    if acc is None:
        return None
    return _HLL_MAGIC + bytes([p0]) + acc.tobytes()


def hll_estimate(blob: bytes) -> float:
    p, regs = _hll_regs(bytes(blob))
    m = 1 << p
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)))
    zeros = int(np.sum(regs == 0))
    if est <= 2.5 * m and zeros:
        est = m * np.log(m / zeros)       # small-range correction
    return float(est)


# -- theta (K minimum values) ------------------------------------------------

def theta_build(col, k: int = _DEFAULT_K) -> bytes:
    arr = col if isinstance(col, pa.ChunkedArray) else pa.chunked_array(
        [col])
    import pyarrow.compute as pc
    arr = arr.filter(pc.is_valid(arr))
    hashes = np.unique(hash_column(arr)) if len(arr) else \
        np.zeros(0, np.uint64)
    hashes = hashes[:k]
    return (_THETA_MAGIC + struct.pack("<HI", k, len(hashes))
            + hashes.astype("<u8").tobytes())


def _theta_parts(blob: bytes):
    if blob[:4] != _THETA_MAGIC:
        raise ValueError("not a PTTH sketch")
    k, n = struct.unpack_from("<HI", blob, 4)
    return k, np.frombuffer(blob, "<u8", n, 10)


def theta_union(blobs: Iterable[bytes]) -> Optional[bytes]:
    ks, all_h = [], []
    for b in blobs:
        if b is None:
            continue
        k, h = _theta_parts(bytes(b))
        ks.append(k)
        all_h.append(h)
    if not ks:
        return None
    k = min(ks)
    merged = np.unique(np.concatenate(all_h))[:k]
    return (_THETA_MAGIC + struct.pack("<HI", k, len(merged))
            + merged.astype("<u8").tobytes())


def theta_estimate(blob: bytes) -> float:
    k, h = _theta_parts(bytes(blob))
    if len(h) < k:
        return float(len(h))              # exact below capacity
    theta = float(h[-1]) / float(1 << 64)
    return (len(h) - 1) / theta
