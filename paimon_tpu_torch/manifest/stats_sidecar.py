"""Columnar manifest-stats sidecar: vectorised manifest pruning.

Counterpart of paimon_tpu/manifest/stats_sidecar.py; the bytes on disk
are the reference's, so each package prunes with the other's sidecar.
Every manifest list `manifest-list-*` may carry a `stats-<name>`
sidecar: one Arrow IPC stream table with a row per manifest file
holding the manifest's partition min/max (typed columns), bucket range
and first-primary-key-field range.  Scan planning reads the sidecar
(one read per list) and evaluates the scan's partition, bucket and key
predicates against the whole batch with Arrow compute, so a pruned
manifest is never fetched and none of its entries are decoded
(reference AbstractFileStoreScan manifest-level pruning).

All pruning is conservative: a null or missing stat keeps the
manifest, a missing sidecar keeps the per-meta Python check, and only
necessary-condition bounds (predicate.conjunctive_bounds) drop one.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

__all__ = ["SIDECAR_PREFIX", "sidecar_name", "sidecar_path",
           "build_sidecar", "read_sidecar", "prune_keep_mask"]

# prefix, not a suffix: nothing pattern-matching `manifest-list-*`
# (tests, repair tooling, ad-hoc scripts) may ever mistake a sidecar
# for a manifest list
SIDECAR_PREFIX = "stats-"


def sidecar_name(list_name: str) -> str:
    return SIDECAR_PREFIX + list_name


def sidecar_path(list_path: str) -> str:
    d, _, base = list_path.rpartition("/")
    return (d + "/" if d else "") + sidecar_name(base)


def _arrow_types(data_types) -> Optional[list]:
    from paimon_tpu_torch.types import data_type_to_arrow
    out = []
    for t in data_types:
        try:
            out.append(data_type_to_arrow(t.as_nullable()))
        except (ValueError, NotImplementedError):
            return None
    return out


def _coerce(values: list, typ: pa.DataType) -> pa.Array:
    """Typed column from python scalars; any coercion failure degrades
    the WHOLE column to nulls (never a wrong bound)."""
    try:
        return pa.array(values, typ)
    except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError,
            OverflowError, TypeError):
        return pa.nulls(len(values), typ)


def build_sidecar(metas: Sequence, partition_types: list,
                  key_types: Optional[list]) -> Optional[bytes]:
    """Serialize the sidecar table for one manifest list.  Rows are
    derived purely from each ManifestFileMeta (partition_stats +
    min/max bucket + min/max key bytes), so stats survive base-list
    rewrites without the original entries in memory.  Returns None
    when nothing typed can be built (no partition or key columns)."""
    from paimon_tpu_torch.data.binary_row import BinaryRowCodec

    p_arrow = _arrow_types(partition_types) if partition_types else []
    k_arrow = _arrow_types(key_types[:1]) if key_types else []
    if p_arrow is None:
        p_arrow = []
    if k_arrow is None:
        k_arrow = []
    if not p_arrow and not k_arrow:
        return None

    n = len(metas)
    names: List[str] = []
    min_b: List[Optional[int]] = []
    max_b: List[Optional[int]] = []
    p_mins = [[None] * n for _ in p_arrow]
    p_maxs = [[None] * n for _ in p_arrow]
    k_min: List[object] = [None] * n
    k_max: List[object] = [None] * n
    p_codec = BinaryRowCodec(partition_types) if p_arrow else None
    k_codec = BinaryRowCodec([t.copy(False) for t in key_types[:1]]) \
        if k_arrow else None

    for row, m in enumerate(metas):
        names.append(m.file_name)
        min_b.append(getattr(m, "min_bucket", None))
        max_b.append(getattr(m, "max_bucket", None))
        if p_codec is not None:
            stats = m.partition_stats
            if stats is not None and stats.min_values and stats.max_values:
                try:
                    mins = p_codec.from_bytes(stats.min_values)
                    maxs = p_codec.from_bytes(stats.max_values)
                    for i in range(len(p_arrow)):
                        p_mins[i][row] = mins[i]
                        p_maxs[i][row] = maxs[i]
                # stats are advisory: an undecodable partition row
                # leaves the column null, which the prune keeps
                except Exception:           # noqa: BLE001
                    pass
        if k_codec is not None:
            mk = getattr(m, "min_key", None)
            xk = getattr(m, "max_key", None)
            if mk and xk:
                try:
                    k_min[row] = k_codec.from_bytes(mk)[0]
                    k_max[row] = k_codec.from_bytes(xk)[0]
                # an undecodable key leaves the bound null (kept)
                except Exception:           # noqa: BLE001
                    pass

    cols: Dict[str, pa.Array] = {
        "file_name": pa.array(names, pa.string()),
        "min_bucket": _coerce(min_b, pa.int32()),
        "max_bucket": _coerce(max_b, pa.int32()),
    }
    for i, t in enumerate(p_arrow):
        cols[f"p{i}_min"] = _coerce(p_mins[i], t)
        cols[f"p{i}_max"] = _coerce(p_maxs[i], t)
    if k_arrow:
        cols["k_min"] = _coerce(k_min, k_arrow[0])
        cols["k_max"] = _coerce(k_max, k_arrow[0])
    table = pa.table(cols)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


def read_sidecar(file_io, list_path: str) -> Optional[pa.Table]:
    """The sidecar table for one manifest list, or None when absent or
    undecodable (pruning then falls back to the python path)."""
    try:
        data = file_io.read_bytes(sidecar_path(list_path))
        with pa.ipc.open_stream(io.BytesIO(data)) as r:
            return r.read_all()
    except Exception:                       # noqa: BLE001 — advisory
        return None


def _overlap_mask(min_col: pa.ChunkedArray, max_col: pa.ChunkedArray,
                  lo, hi, typ: pa.DataType) -> Optional[np.ndarray]:
    """keep[i] = [min_i, max_i] may intersect [lo, hi]; nulls keep.
    None when the literals cannot be coerced to the column type."""
    import pyarrow.compute as pc
    keep = np.ones(len(min_col), dtype=bool)
    try:
        if hi is not None:
            m = pc.fill_null(pc.less_equal(min_col, pa.scalar(hi, typ)),
                             True)
            keep &= m.combine_chunks().to_numpy(zero_copy_only=False)
        if lo is not None:
            m = pc.fill_null(pc.greater_equal(max_col, pa.scalar(lo, typ)),
                             True)
            keep &= m.combine_chunks().to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError,
            OverflowError, TypeError):
        return None
    return keep


def prune_keep_mask(stats: pa.Table, partition_keys: Sequence[str],
                    partition_filter: Optional[dict],
                    bucket_filter: Optional[set],
                    key_bounds: Optional[Tuple]) -> np.ndarray:
    """Vectorized keep mask over one manifest list's sidecar rows.
    Every failure mode (missing column, uncoercible literal) degrades
    to keep for the affected constraint."""
    n = stats.num_rows
    keep = np.ones(n, dtype=bool)
    cols = set(stats.column_names)

    if partition_filter:
        for i, k in enumerate(partition_keys):
            if k not in partition_filter:
                continue
            lo_c, hi_c = f"p{i}_min", f"p{i}_max"
            if lo_c not in cols or hi_c not in cols:
                continue
            v = partition_filter[k]
            m = _overlap_mask(stats[lo_c], stats[hi_c], v, v,
                              stats.schema.field(lo_c).type)
            if m is not None:
                keep &= m

    if bucket_filter:
        real = {b for b in bucket_filter if b >= 0}
        # prune only on an all-real filter: special buckets (-2
        # postpone staging) sit outside the range containment
        if real == set(bucket_filter) and real \
                and "min_bucket" in cols and "max_bucket" in cols:
            m = _overlap_mask(stats["min_bucket"], stats["max_bucket"],
                              min(real), max(real), pa.int32())
            if m is not None:
                keep &= m

    if key_bounds is not None and "k_min" in cols and "k_max" in cols:
        lo, hi = key_bounds
        m = _overlap_mask(stats["k_min"], stats["k_max"], lo, hi,
                          stats.schema.field("k_min").type)
        if m is not None:
            keep &= m

    return keep
