"""The column hash of the bloom file index.

Counterpart of paimon_tpu/index/bloom.py, reduced to `hash_column`, which
the cardinality sketches of ops/sketch.py build on; the bloom filter
itself is not ported yet (ROADMAP.md: the remaining planes).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

__all__ = ["hash_column"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


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
