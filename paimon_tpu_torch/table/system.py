"""System tables: the queryable observability surface.

Counterpart of paimon_tpu/table/system.py.  `binlog` builds its list
columns over the read's own arrays where the reference's row-by-row
Python gives the same table (the types Arrow infers back from Python
values), and takes the reference's path otherwise.

reference: table/system/SystemTableLoader.java + 24 system table impls
(SnapshotsTable, SchemasTable, FilesTable, ManifestsTable, TagsTable,
BranchesTable, ConsumersTable, OptionsTable, PartitionsTable,
BucketsTable, AuditLogTable...). Each loads as an Arrow table via
`table.system_table(name)` or `catalog.get_table("db.t$snapshots")`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

__all__ = ["SYSTEM_TABLES", "load_system_table"]


def _snapshots(table) -> pa.Table:
    rows = []
    for s in table.snapshot_manager.snapshots():
        rows.append({
            "snapshot_id": s.id, "schema_id": s.schema_id,
            "commit_user": s.commit_user,
            "commit_identifier": s.commit_identifier,
            "commit_kind": s.commit_kind, "commit_time": s.time_millis,
            "base_manifest_list": s.base_manifest_list,
            "delta_manifest_list": s.delta_manifest_list,
            "changelog_manifest_list": s.changelog_manifest_list,
            "total_record_count": s.total_record_count,
            "delta_record_count": s.delta_record_count,
            "changelog_record_count": s.changelog_record_count,
            "watermark": s.watermark,
        })
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "snapshot_id": pa.array([], pa.int64())})


def _schemas(table) -> pa.Table:
    rows = []
    for sid in table.schema_manager.list_all_ids():
        ts = table.schema_manager.schema(sid)
        rows.append({
            "schema_id": ts.id,
            "fields": str([f.name for f in ts.fields]),
            "partition_keys": str(ts.partition_keys),
            "primary_keys": str(ts.primary_keys),
            "options": str(ts.options),
            "comment": getattr(ts, "comment", None),
        })
    return pa.Table.from_pylist(rows)


def _options(table) -> pa.Table:
    opts = table.schema.options
    return pa.table({
        "key": pa.array(list(opts.keys()), pa.string()),
        "value": pa.array([str(v) for v in opts.values()], pa.string()),
    })


def _files(table) -> pa.Table:
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return pa.table({"file_path": pa.array([], pa.string())})
    scan = table.new_scan()
    rows = []
    for e in scan.read_entries(snapshot):
        partition = scan._partition_codec.from_bytes(e.partition)
        f = e.file
        rows.append({
            "partition": str(list(partition)),
            "bucket": e.bucket,
            "file_path": f.external_path or
                scan.path_factory.data_file_path(
                    partition, e.bucket, f.file_name),
            "file_name": f.file_name,
            "file_format": f.file_name.rsplit(".", 1)[-1],
            "schema_id": f.schema_id,
            "level": f.level,
            "record_count": f.row_count,
            "file_size_in_bytes": f.file_size,
            "min_sequence_number": f.min_sequence_number,
            "max_sequence_number": f.max_sequence_number,
            "deleted_record_count": f.delete_row_count or 0,
        })
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "file_path": pa.array([], pa.string())})


def _manifests(table) -> pa.Table:
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return pa.table({"file_name": pa.array([], pa.string())})
    scan = table.new_scan()
    metas = scan.manifest_list.read_all(snapshot.base_manifest_list,
                                        snapshot.delta_manifest_list)
    rows = [{
        "file_name": m.file_name,
        "file_size": m.file_size,
        "num_added_files": m.num_added_files,
        "num_deleted_files": m.num_deleted_files,
        "schema_id": m.schema_id,
    } for m in metas]
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "file_name": pa.array([], pa.string())})


def _tags(table) -> pa.Table:
    rows = [{
        "tag_name": name,
        "snapshot_id": snap.id,
        "schema_id": snap.schema_id,
        "commit_time": snap.time_millis,
        "record_count": snap.total_record_count,
    } for name, snap in table.tag_manager.tags().items()]
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "tag_name": pa.array([], pa.string())})


def _branches(table) -> pa.Table:
    rows = [{"branch_name": b} for b in table.branch_manager.branches()]
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "branch_name": pa.array([], pa.string())})


def _consumers(table) -> pa.Table:
    rows = [{"consumer_id": cid, "next_snapshot_id": nxt}
            for cid, nxt in table.consumer_manager.consumers().items()]
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "consumer_id": pa.array([], pa.string())})


def _partitions(table) -> pa.Table:
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return pa.table({"partition": pa.array([], pa.string())})
    scan = table.new_scan()
    agg: Dict[bytes, Dict] = {}
    for e in scan.read_entries(snapshot):
        d = agg.setdefault(e.partition, {
            "partition": str(list(
                scan._partition_codec.from_bytes(e.partition))),
            "record_count": 0, "file_size_in_bytes": 0, "file_count": 0})
        d["record_count"] += e.file.row_count
        d["file_size_in_bytes"] += e.file.file_size
        d["file_count"] += 1
    return pa.Table.from_pylist(list(agg.values())) if agg else pa.table({
        "partition": pa.array([], pa.string())})


def _buckets(table) -> pa.Table:
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return pa.table({"bucket": pa.array([], pa.int32())})
    scan = table.new_scan()
    agg: Dict = {}
    for e in scan.read_entries(snapshot):
        key = (e.partition, e.bucket)
        d = agg.setdefault(key, {
            "partition": str(list(
                scan._partition_codec.from_bytes(e.partition))),
            "bucket": e.bucket, "record_count": 0,
            "file_size_in_bytes": 0, "file_count": 0})
        d["record_count"] += e.file.row_count
        d["file_size_in_bytes"] += e.file.file_size
        d["file_count"] += 1
    return pa.Table.from_pylist(list(agg.values())) if agg else pa.table({
        "bucket": pa.array([], pa.int32())})


def _audit_log(table) -> pa.Table:
    """Batch audit log: the latest snapshot's rows with rowkind column
    (reference AuditLogTable; streaming variant = stream scan)."""
    from paimon_tpu_torch.core.read import ROW_KIND_COL

    plan = table.new_scan().plan(streaming=True)
    rb = table.new_read_builder()
    out = rb.new_read().to_arrow(plan)
    kinds = out.column(ROW_KIND_COL)
    mapping = {0: "+I", 1: "-U", 2: "+U", 3: "-D"}
    rowkind = pa.array([mapping[k.as_py()] for k in kinds], pa.string())
    out = out.drop_columns([ROW_KIND_COL])
    return out.add_column(0, "rowkind", rowkind)


def _read_optimized(table) -> pa.Table:
    """Rows from the highest level only — a no-merge fast view that
    trades freshness for raw-read speed (reference ReadOptimizedTable:
    'files with maximum level, strongly read-optimized')."""
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return table.to_arrow().slice(0, 0)
    if not table.primary_keys:
        return table.to_arrow()
    max_level = table.options.max_level
    scan = table.new_scan().with_level_filter(
        lambda level: level == max_level)
    plan = scan.plan(snapshot)
    return table.new_read_builder().new_read().to_arrow(plan.splits)


def _aggregation_fields(table) -> pa.Table:
    """Per-field aggregate configuration (reference
    AggregationFieldsTable)."""
    from paimon_tpu_torch.ops.agg import field_aggregators
    aggs = field_aggregators(table.schema, table.options)
    rows = []
    for f in table.schema.fields:
        func = aggs.get(f.name)
        opts = {k: v for k, v in table.schema.options.items()
                if k.startswith(f"fields.{f.name}.")}
        rows.append({
            "field_name": f.name,
            "field_type": str(f.type),
            "function": func if f.name in aggs else "primary-key",
            "function_options": str(opts) if opts else "",
            "comment": getattr(f, "description", None),
        })
    return pa.Table.from_pylist(rows)


def _statistics(table) -> pa.Table:
    """Latest ANALYZE result (reference StatisticTable)."""
    import json
    stats = table.statistics()
    if not stats:
        return pa.table({"snapshot_id": pa.array([], pa.int64())})
    return pa.Table.from_pylist([{
        "snapshot_id": stats.get("snapshotId"),
        "schema_id": stats.get("schemaId"),
        "merged_record_count": stats.get("mergedRecordCount"),
        "merged_record_size": stats.get("mergedRecordSize"),
        "col_stats": json.dumps(stats.get("colStats", {}),
                                default=str),
    }])


def _binlog(table) -> pa.Table:
    """Changelog packed one row per change: -U/+U pairs of a key fold
    into single rows whose columns are [before, after] arrays; +I/-D
    become single-element arrays (reference BinlogTable)."""
    from paimon_tpu_torch.core.read import ROW_KIND_COL

    plan = table.new_scan().plan(streaming=True)
    raw = table.new_read_builder().new_read().to_arrow(plan)
    pk = table.schema.primary_keys
    fast = _binlog_columnar(raw, ROW_KIND_COL, pk)
    if fast is not None:
        return fast
    kinds = [k.as_py() for k in raw.column(ROW_KIND_COL)]
    raw = raw.drop_columns([ROW_KIND_COL])
    value_cols = raw.column_names
    lists = raw.to_pylist()
    rows = []
    i = 0
    while i < len(lists):
        kind = kinds[i]
        if kind == 1 and i + 1 < len(lists) and kinds[i + 1] == 2 and \
                pk and all(lists[i][k] == lists[i + 1][k] for k in pk):
            # fold only a true -U/+U pair OF THE SAME KEY; adjacent
            # events of different keys stay separate rows
            before, after = lists[i], lists[i + 1]
            rows.append({"rowkind": "+U",
                         **{c: [before[c], after[c]]
                            for c in value_cols}})
            i += 2
            continue
        label = {0: "+I", 1: "-U", 2: "+U", 3: "-D"}[kind]
        rows.append({"rowkind": label,
                     **{c: [lists[i][c]] for c in value_cols}})
        i += 1
    if not rows:
        return pa.table({"rowkind": pa.array([], pa.string())})
    return pa.Table.from_pylist(rows)


def _inferred_type(col: pa.ChunkedArray) -> Optional[pa.DataType]:
    """The type `pa.Table.from_pylist` infers back from `col`'s Python
    values, for the types where that is certain (integers, floats,
    booleans, strings, binaries and structs of them, each with a
    non-null value); None for any other."""
    t = col.type
    if col.null_count == len(col):
        return None
    if pa.types.is_integer(t):
        return pa.int64()
    if pa.types.is_float32(t) or pa.types.is_float64(t):
        return pa.float64()
    if pa.types.is_boolean(t):
        return pa.bool_()
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return pa.string()
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return pa.binary()
    if pa.types.is_struct(t):
        arr = col.combine_chunks()
        if arr.null_count:
            arr = arr.filter(pc.invert(arr.is_null()))
        fields = []
        for i in range(t.num_fields):
            child = _inferred_type(pa.chunked_array([arr.field(i)]))
            if child is None:
                return None
            fields.append(pa.field(t.field(i).name, child))
        return pa.struct(fields)
    return None


def _binlog_columnar(raw: pa.Table, kind_col: str,
                     pk: List[str]) -> Optional[pa.Table]:
    """The reference's binlog built over `raw`'s arrays: each output row
    is a list column over one input row, or over the two rows of a -U/+U
    pair of one key (consecutive, so the lists' values are the columns
    themselves); None where the row-by-row path could infer other types,
    or a string or binary column overflows one array."""
    n = raw.num_rows
    if n == 0:
        return None
    kinds = np.asarray(raw.column(kind_col).combine_chunks()
                       .cast(pa.int8()))
    raw = raw.drop_columns([kind_col])
    types = [_inferred_type(c) for c in raw.columns]
    if any(t is None for t in types):
        return None
    pair = np.zeros(n, dtype=bool)       # row i folds with row i + 1
    if pk and n > 1:
        pair[:-1] = (kinds[:-1] == 1) & (kinds[1:] == 2)
        for k in pk:
            col = raw.column(k).combine_chunks()
            a, b = col.slice(0, n - 1), col.slice(1)
            same = pc.fill_null(pc.equal(a, b), False)
            both_null = pc.and_(a.is_null(), b.is_null())
            pair[:-1] &= np.asarray(pc.or_(same, both_null))
    second = np.zeros(n, dtype=bool)
    second[1:] = pair[:-1]
    starts = np.flatnonzero(~second)
    offsets = pa.array(np.append(starts, n).astype(np.int32))
    labels = np.array(["+I", "-U", "+U", "-D"])[kinds[starts]]
    labels[pair[starts]] = "+U"
    arrays = [pa.array(labels, pa.string())]
    try:
        for col, t in zip(raw.columns, types):
            arrays.append(pa.ListArray.from_arrays(
                offsets, col.combine_chunks().cast(t)))
    except (pa.ArrowInvalid, pa.ArrowCapacityError):
        return None
    return pa.Table.from_arrays(arrays, names=["rowkind"] + raw.column_names)


def _table_indexes(table) -> pa.Table:
    """Index manifest inventory: DVs, dynamic-bucket hash indexes...
    (reference TableIndexesTable)."""
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None or not snapshot.index_manifest:
        return pa.table({"index_type": pa.array([], pa.string())})
    scan = table.new_scan()
    rows = []
    for e in scan.index_manifest_file.read(snapshot.index_manifest):
        rows.append({
            "partition": str(list(
                scan._partition_codec.from_bytes(e.partition))),
            "bucket": e.bucket,
            "index_type": e.index_file.index_type,
            "file_name": e.index_file.file_name,
            "file_size": e.index_file.file_size,
            "row_count": e.index_file.row_count,
        })
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "index_type": pa.array([], pa.string())})


def _file_key_ranges(table) -> pa.Table:
    """Decoded per-file primary-key ranges (reference
    FileKeyRangesTable)."""
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return pa.table({"file_name": pa.array([], pa.string())})
    from paimon_tpu_torch.data.binary_row import BinaryRowCodec
    scan = table.new_scan()
    pk_types = [table.schema.logical_row_type().get_field(k).type
                .copy(False)
                for k in table.schema.trimmed_primary_keys()]
    codec = BinaryRowCodec(pk_types) if pk_types else None
    rows = []
    for e in scan.read_entries(snapshot):
        f = e.file
        rows.append({
            "partition": str(list(
                scan._partition_codec.from_bytes(e.partition))),
            "bucket": e.bucket,
            "file_name": f.file_name,
            "level": f.level,
            "min_key": str(list(codec.from_bytes(f.min_key)))
            if codec and f.min_key else None,
            "max_key": str(list(codec.from_bytes(f.max_key)))
            if codec and f.max_key else None,
            "record_count": f.row_count,
        })
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "file_name": pa.array([], pa.string())})


def _row_tracking(table) -> pa.Table:
    """Row-id ranges per data file of a tracked append table
    (reference RowTrackingTable)."""
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return pa.table({"file_name": pa.array([], pa.string())})
    scan = table.new_scan()
    rows = []
    for e in scan.read_entries(snapshot):
        f = e.file
        rows.append({
            "partition": str(list(
                scan._partition_codec.from_bytes(e.partition))),
            "bucket": e.bucket,
            "file_name": f.file_name,
            "first_row_id": f.first_row_id,
            "row_count": f.row_count,
            "write_cols": str(f.write_cols) if f.write_cols else None,
            "next_row_id_after": None if f.first_row_id is None
            else f.first_row_id + f.row_count,
        })
    return pa.Table.from_pylist(rows) if rows else pa.table({
        "file_name": pa.array([], pa.string())})


_METRICS_SCHEMA = pa.schema([
    ("group", pa.string()), ("table", pa.string()),
    ("metric", pa.string()), ("kind", pa.string()),
    ("value", pa.float64()), ("count", pa.int64()),
    ("mean", pa.float64()), ("p95", pa.float64()),
    ("max", pa.float64())])


def _metrics(table) -> pa.Table:
    """Live process metric registry as rows (ours; the observability
    plane's queryable surface).  One row per metric, histograms carry
    count/mean/p95/max; serialized via MetricRegistry.snapshot_rows —
    the same point behind the Prometheus endpoint and bench snapshots.
    The schema is pinned: inferred types would flip to null when e.g.
    no histogram exists yet."""
    from paimon_tpu_torch.metrics import global_registry
    rows = []
    for r in global_registry().snapshot_rows():
        rows.append({
            "group": r["group"],
            "table": r["table"] or None,
            "metric": r["metric"],
            "kind": r["kind"],
            "value": float(r["value"]),
            "count": int(r["count"]) if r["kind"] == "histogram"
            else None,
            "mean": float(r["mean"]) if r["kind"] == "histogram"
            else None,
            "p95": float(r["p95"]) if r["kind"] == "histogram" else None,
            "max": float(r["max"]) if r["kind"] == "histogram" else None,
        })
    return pa.Table.from_pylist(rows, schema=_METRICS_SCHEMA)


_TRACES_SCHEMA = pa.schema([
    ("name", pa.string()), ("cat", pa.string()),
    ("thread", pa.string()), ("tid", pa.int64()),
    ("span_id", pa.int64()), ("parent_id", pa.int64()),
    ("start_us", pa.int64()), ("dur_us", pa.int64()),
    ("table", pa.string()), ("partition", pa.string()),
    ("bucket", pa.int64()), ("snapshot", pa.int64()),
    ("attempt", pa.int64()), ("attrs", pa.string())])


def _traces(table) -> pa.Table:
    """Recent spans from the bounded trace ring (ours).  Well-known
    attributes (table/partition/bucket/snapshot/attempt) get columns;
    the rest land in an `attrs` JSON column.  Empty (typed) unless
    trace.enabled / obs.enable_tracing() collected spans; the schema
    is pinned so all-null columns don't infer as null type."""
    import json as _json

    from paimon_tpu_torch.obs.trace import take_spans
    rows = []
    for s in take_spans():
        attrs = dict(s.attrs)
        bucket = attrs.pop("bucket", None)
        snap = attrs.pop("snapshot", None)
        attempt = attrs.pop("attempt", None)
        rows.append({
            "name": s.name,
            "cat": s.cat or None,
            "thread": s.thread,
            "tid": s.tid,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "start_us": int(s.start_us),
            "dur_us": int(s.dur_us),
            "table": _opt_str(attrs.pop("table", None)),
            "partition": _opt_str(attrs.pop("partition", None)),
            "bucket": bucket if isinstance(bucket, int) else None,
            "snapshot": snap if isinstance(snap, int) else None,
            "attempt": attempt if isinstance(attempt, int) else None,
            "attrs": _json.dumps(attrs, default=str) if attrs else None,
        })
    return pa.Table.from_pylist(rows, schema=_TRACES_SCHEMA)


def _opt_str(v):
    return None if v is None else str(v)


SYSTEM_TABLES: Dict[str, Callable] = {
    "snapshots": _snapshots,
    "schemas": _schemas,
    "options": _options,
    "files": _files,
    "manifests": _manifests,
    "tags": _tags,
    "branches": _branches,
    "consumers": _consumers,
    "partitions": _partitions,
    "buckets": _buckets,
    "audit_log": _audit_log,
    "read_optimized": _read_optimized,
    "aggregation_fields": _aggregation_fields,
    "statistics": _statistics,
    "binlog": _binlog,
    "table_indexes": _table_indexes,
    "file_key_ranges": _file_key_ranges,
    "row_tracking": _row_tracking,
    "metrics": _metrics,
    "traces": _traces,
}


def load_system_table(table, name: str) -> pa.Table:
    """reference table/system/SystemTableLoader.java."""
    key = name.lower()
    if key not in SYSTEM_TABLES:
        raise ValueError(f"Unknown system table {name!r}; available: "
                         f"{sorted(SYSTEM_TABLES)}")
    return SYSTEM_TABLES[key](table)
