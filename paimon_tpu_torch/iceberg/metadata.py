"""Iceberg v2 metadata generation.

Counterpart of paimon_tpu/iceberg/metadata.py.

reference: iceberg/IcebergCommitCallback.java + iceberg/metadata/*
(IcebergMetadata, IcebergSnapshot, IcebergSchema, IcebergPartitionSpec)
+ iceberg/manifest/* (avro manifest list + manifest entries). Layout:

    <table>/metadata/v<N>.metadata.json
    <table>/metadata/version-hint.text
    <table>/metadata/snap-<id>.avro              (manifest list)
    <table>/metadata/manifest-<uuid>.avro        (manifest entries)

Only data files the CURRENT paimon snapshot references are exported
(each sync is a full replacement snapshot — operation 'overwrite').
Append tables export every live file; primary-key tables export the
READ-OPTIMIZED view — top-level (fully compacted) files only, since an
Iceberg reader cannot run the merge — so upserts become visible to
Iceberg readers after a full compaction, matching the reference's pk
contract (docs/iceberg).

Where a file the export would list carries a deletion vector in the
exported snapshot (an append table after `delete_where`), the export
raises and writes nothing: an Iceberg reader of the plain data files
would read the deleted rows back (paimon_tpu's export lists such files
as if whole).  Iceberg position-delete files are not written.
"""

from __future__ import annotations

import json
import uuid
from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.format import avro as avro_fmt
from paimon_tpu_torch.types import (
    BigIntType, BooleanType, DataType, DateType, DecimalType, DoubleType,
    FloatType, IntType, LocalZonedTimestampType, SmallIntType,
    TimestampType, TinyIntType, VarCharType,
)

__all__ = ["sync_iceberg"]


def _iceberg_type(t: DataType) -> str:
    if isinstance(t, BooleanType):
        return "boolean"
    if isinstance(t, (TinyIntType, SmallIntType, IntType)):
        return "int"
    if isinstance(t, BigIntType):
        return "long"
    if isinstance(t, FloatType):
        return "float"
    if isinstance(t, DoubleType):
        return "double"
    if isinstance(t, DateType):
        return "date"
    if isinstance(t, LocalZonedTimestampType):
        return "timestamptz"
    if isinstance(t, TimestampType):
        return "timestamp"
    if isinstance(t, DecimalType):
        return f"decimal({t.precision}, {t.scale})"
    return "string"


def _iceberg_schema(schema) -> dict:
    return {
        "type": "struct",
        "schema-id": schema.id,
        "fields": [{
            "id": f.id + 1,              # iceberg ids are 1-based
            "name": f.name,
            "required": not f.type.nullable,
            "type": _iceberg_type(f.type),
        } for f in schema.fields],
        "identifier-field-ids": [
            f.id + 1 for f in schema.fields
            if f.name in schema.primary_keys],
    }


def _partition_spec(schema) -> dict:
    fields = []
    by_name = {f.name: f for f in schema.fields}
    for i, k in enumerate(schema.partition_keys):
        fields.append({
            "name": k,
            "transform": "identity",
            "source-id": by_name[k].id + 1,
            "field-id": 1000 + i,
        })
    return {"spec-id": 0, "fields": fields}


_DATA_FILE_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"],
         "field-id": 1, "default": None},
        {"name": "sequence_number", "type": ["null", "long"],
         "field-id": 3, "default": None},
        {"name": "file_sequence_number", "type": ["null", "long"],
         "field-id": 4, "default": None},
        {"name": "data_file", "field-id": 2, "type": {
            "type": "record", "name": "r2", "fields": [
                {"name": "content", "type": "int", "field-id": 134},
                {"name": "file_path", "type": "string", "field-id": 100},
                {"name": "file_format", "type": "string",
                 "field-id": 101},
                {"name": "partition", "field-id": 102, "type": {
                    "type": "record", "name": "r102", "fields": []}},
                {"name": "record_count", "type": "long", "field-id": 103},
                {"name": "file_size_in_bytes", "type": "long",
                 "field-id": 104},
            ]}},
    ]}

_MANIFEST_FILE_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "content", "type": "int", "field-id": 517},
        {"name": "sequence_number", "type": "long", "field-id": 515},
        {"name": "min_sequence_number", "type": "long", "field-id": 516},
        {"name": "added_snapshot_id", "type": "long", "field-id": 503},
        {"name": "added_files_count", "type": "int", "field-id": 504},
        {"name": "existing_files_count", "type": "int", "field-id": 505},
        {"name": "deleted_files_count", "type": "int", "field-id": 506},
        {"name": "added_rows_count", "type": "long", "field-id": 512},
        {"name": "existing_rows_count", "type": "long", "field-id": 513},
        {"name": "deleted_rows_count", "type": "long", "field-id": 514},
    ]}


def _partition_entry_schema(schema) -> Tuple[dict, List[str]]:
    """Manifest entry schema whose data_file.partition record mirrors the
    table's identity partition fields."""
    import copy

    entry = copy.deepcopy(_DATA_FILE_SCHEMA)
    by_name = {f.name: f for f in schema.fields}
    part_fields = []
    type_map = {"int": "int", "long": "long", "string": "string",
                "boolean": "boolean", "double": "double", "float": "float",
                "date": "int"}
    for k in schema.partition_keys:
        it = _iceberg_type(by_name[k].type)
        part_fields.append({
            "name": k,
            "type": ["null", type_map.get(it, "string")],
            "field-id": by_name[k].id + 1,
            "default": None,
        })
    entry["fields"][4]["type"]["fields"][3]["type"]["fields"] = \
        part_fields
    return entry, list(schema.partition_keys)


def _refuse_deleted_rows(table, scan, snapshot, exported) -> None:
    """Raise ValueError, naming the table and the file, where a file of
    `exported` has rows deleted by a deletion vector of `snapshot`: the
    export lists data files whole, so an Iceberg reader would read
    those rows back."""
    vectors = scan._load_deletion_vectors(snapshot, unfiltered=True)
    if not vectors:
        return
    for e in exported:
        dv = vectors.get((e.partition, e.bucket), {}).get(e.file.file_name)
        if dv is not None and not dv.is_empty():
            raise ValueError(
                f"sync_iceberg: table {table.path}: data file "
                f"{e.file.file_name} (bucket {e.bucket}) has "
                f"{dv.cardinality()} rows deleted by a deletion vector "
                f"of snapshot {snapshot.id}; the Iceberg export lists data "
                f"files whole and writes no position deletes, so an "
                f"Iceberg reader would read them back (compact the table "
                f"first)")


def sync_iceberg(table, committer=None) -> Optional[str]:
    """Export the table's current snapshot as Iceberg v2 metadata.
    Returns the metadata file path (or None when there is no snapshot).

    `committer` (optional, iceberg/rest.py IcebergRestCommitter) also
    publishes the export to an Iceberg REST catalog after the file
    metadata is written, passing the PREVIOUS export's snapshot id as
    the CAS base — reference IcebergCommitCallback +
    IcebergRestMetadataCommitter.commitMetadata(newPath, basePath)."""
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return None
    scan = table.new_scan()
    entries = scan.read_entries(snapshot)
    schema = table.schema
    meta_dir = f"{table.path}/metadata"
    fio = table.file_io

    entry_schema, part_keys = _partition_entry_schema(schema)
    # primary-key tables expose the READ-OPTIMIZED view: only top-level
    # (fully compacted, non-overlapping, deletes folded) files are
    # consumable by an engine that cannot run the merge — matching the
    # reference's Iceberg compat contract for pk tables ("visible after
    # full compaction", docs/iceberg + IcebergCommitCallback)
    max_level = None
    if table.primary_keys:
        max_level = table.options.max_level
    exported = [e for e in entries if e.bucket != -2 and (
        max_level is None or e.file.level == max_level)]
    _refuse_deleted_rows(table, scan, snapshot, exported)
    records = []
    total_rows = 0
    for e in exported:
        partition = scan._partition_codec.from_bytes(e.partition)
        path = e.file.external_path or scan.path_factory.data_file_path(
            partition, e.bucket, e.file.file_name)
        fmt = e.file.file_name.rsplit(".", 1)[-1].upper()
        records.append({
            "status": 1,                     # ADDED
            "snapshot_id": snapshot.id,
            "sequence_number": snapshot.id,
            "file_sequence_number": snapshot.id,
            "data_file": {
                "content": 0,               # DATA
                "file_path": path,
                "file_format": fmt,
                "partition": dict(zip(part_keys, partition)),
                "record_count": e.file.row_count,
                "file_size_in_bytes": e.file.file_size,
            }})
        total_rows += e.file.row_count

    manifest_name = f"manifest-{uuid.uuid4()}.avro"
    manifest_path = f"{meta_dir}/{manifest_name}"
    manifest_bytes = avro_fmt.write_container(entry_schema, records,
                                              codec="null")
    fio.write_bytes(manifest_path, manifest_bytes, overwrite=False)

    list_name = f"snap-{snapshot.id}-{uuid.uuid4()}.avro"
    list_path = f"{meta_dir}/{list_name}"
    fio.write_bytes(list_path, avro_fmt.write_container(
        _MANIFEST_FILE_SCHEMA, [{
            "manifest_path": manifest_path,
            "manifest_length": len(manifest_bytes),
            "partition_spec_id": 0,
            "content": 0,
            "sequence_number": snapshot.id,
            "min_sequence_number": snapshot.id,
            "added_snapshot_id": snapshot.id,
            "added_files_count": len(records),
            "existing_files_count": 0,
            "deleted_files_count": 0,
            "added_rows_count": total_rows,
            "existing_rows_count": 0,
            "deleted_rows_count": 0,
        }], codec="null"), overwrite=False)

    # next metadata version; remember the previous export's snapshot as
    # the REST committer's CAS base
    version = 1
    base_snapshot_id = None
    hint_path = f"{meta_dir}/version-hint.text"
    if fio.exists(hint_path):
        try:
            version = int(fio.read_utf8(hint_path)) + 1
            prev = json.loads(fio.read_utf8(
                f"{meta_dir}/v{version - 1}.metadata.json"))
            base_snapshot_id = prev.get("current-snapshot-id")
        except (ValueError, OSError, FileNotFoundError):
            pass
    metadata = {
        "format-version": 2,
        "table-uuid": str(uuid.uuid5(uuid.NAMESPACE_URL, table.path)),
        "location": table.path,
        "last-sequence-number": snapshot.id,
        "last-updated-ms": snapshot.time_millis,
        "last-column-id": max((f.id + 1 for f in schema.fields),
                              default=0),
        "current-schema-id": schema.id,
        "schemas": [_iceberg_schema(schema)],
        "default-spec-id": 0,
        "partition-specs": [_partition_spec(schema)],
        "last-partition-id": 1000 + max(0, len(schema.partition_keys) - 1),
        "default-sort-order-id": 0,
        "sort-orders": [{"order-id": 0, "fields": []}],
        "properties": {"paimon.snapshot-id": str(snapshot.id)},
        "current-snapshot-id": snapshot.id,
        "snapshots": [{
            "snapshot-id": snapshot.id,
            "sequence-number": snapshot.id,
            "timestamp-ms": snapshot.time_millis,
            "manifest-list": list_path,
            "summary": {"operation": "overwrite"},
            "schema-id": schema.id,
        }],
        "statistics": [],
        "snapshot-log": [],
        "metadata-log": [],
    }
    meta_path = f"{meta_dir}/v{version}.metadata.json"
    fio.write_bytes(meta_path, json.dumps(metadata, indent=2).encode(),
                    overwrite=True)
    fio.write_bytes(hint_path, str(version).encode(), overwrite=True)
    if committer is not None:
        committer.commit_metadata(metadata, base_snapshot_id)
    return meta_path
