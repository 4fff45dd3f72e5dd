"""Independent Iceberg v2 reader.

Counterpart of paimon_tpu/iceberg/reader.py.

Consumes a table's `metadata/` directory purely through the Iceberg
spec (table metadata JSON -> manifest-list avro -> manifest avro ->
data files); shares nothing with the export path in metadata.py except
the generic avro OCF codec and Arrow file readers.  Its role is the
external-consumer check the reference gets from Spark/Trino reading
its Iceberg compat output (no pyiceberg in this environment): if this
reader round-trips the data, the export is structurally consumable.

reference: paimon-core/.../iceberg/ (IcebergCommitCallback writes,
external engines read) + the Iceberg table-spec v2.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import pyarrow as pa

from paimon_tpu_torch.format import avro as avro_fmt
from paimon_tpu_torch.fs.fileio import FileIO, LocalFileIO

_REQUIRED_V2_FIELDS = [
    "format-version", "table-uuid", "location", "last-sequence-number",
    "last-updated-ms", "last-column-id", "current-schema-id", "schemas",
    "default-spec-id", "partition-specs", "current-snapshot-id",
    "snapshots",
]


@dataclass
class IcebergDataFile:
    file_path: str
    file_format: str
    record_count: int
    file_size_in_bytes: int
    partition: Dict[str, Any] = field(default_factory=dict)


class IcebergTable:
    """A read-only view over Iceberg v2 metadata."""

    def __init__(self, metadata: dict, file_io: FileIO):
        self.metadata = metadata
        self.file_io = file_io
        self._validate()

    # -- loading ------------------------------------------------------------
    @staticmethod
    def load(location: str, file_io: Optional[FileIO] = None,
             metadata_file: Optional[str] = None) -> "IcebergTable":
        """Load from a table location (via metadata/version-hint.text)
        or an explicit vN.metadata.json path."""
        fio = file_io or LocalFileIO()
        if metadata_file is None:
            hint = f"{location.rstrip('/')}/metadata/version-hint.text"
            version = int(fio.read_utf8(hint).strip())
            metadata_file = (f"{location.rstrip('/')}/metadata/"
                             f"v{version}.metadata.json")
        metadata = json.loads(fio.read_utf8(metadata_file))
        return IcebergTable(metadata, fio)

    def _validate(self):
        missing = [k for k in _REQUIRED_V2_FIELDS
                   if k not in self.metadata]
        if missing:
            raise ValueError(f"not Iceberg v2 metadata; missing "
                             f"fields: {missing}")
        if self.metadata["format-version"] != 2:
            raise ValueError("only format-version 2 is supported")
        ids = {s["schema-id"] for s in self.metadata["schemas"]}
        if self.metadata["current-schema-id"] not in ids:
            raise ValueError("current-schema-id not in schemas")

    # -- metadata accessors --------------------------------------------------
    @property
    def schema(self) -> dict:
        sid = self.metadata["current-schema-id"]
        return next(s for s in self.metadata["schemas"]
                    if s["schema-id"] == sid)

    @property
    def column_names(self) -> List[str]:
        return [f["name"] for f in self.schema["fields"]]

    def current_snapshot(self) -> Optional[dict]:
        sid = self.metadata.get("current-snapshot-id")
        if sid in (None, -1):
            return None
        return self._snapshot(sid)

    def _snapshot(self, sid: int) -> dict:
        snap = next((s for s in self.metadata["snapshots"]
                     if s["snapshot-id"] == sid), None)
        if snap is None:
            raise ValueError(f"snapshot {sid} not in the metadata's "
                             f"snapshots list")
        return snap

    # -- planning ------------------------------------------------------------
    def plan_files(self, snapshot_id: Optional[int] = None
                   ) -> List[IcebergDataFile]:
        """manifest-list -> manifests -> live data files."""
        snap = (self.current_snapshot() if snapshot_id is None else
                self._snapshot(snapshot_id))
        if snap is None:
            return []
        out: List[IcebergDataFile] = []
        _, mlist = avro_fmt.read_container(
            self.file_io.read_bytes(snap["manifest-list"]))
        for mf in mlist:
            _, entries = avro_fmt.read_container(
                self.file_io.read_bytes(mf["manifest_path"]))
            for e in entries:
                if e["status"] == 2:             # DELETED
                    continue
                df = e["data_file"]
                if df.get("content", 0) != 0:    # only DATA files
                    continue
                out.append(IcebergDataFile(
                    file_path=df["file_path"],
                    file_format=str(df["file_format"]).lower(),
                    record_count=df["record_count"],
                    file_size_in_bytes=df["file_size_in_bytes"],
                    partition=dict(df.get("partition") or {}),
                ))
        return out

    # -- reading -------------------------------------------------------------
    def to_arrow(self, projection: Optional[List[str]] = None
                 ) -> pa.Table:
        """Read the current snapshot's rows (columns of the Iceberg
        schema, in schema order)."""
        cols = projection or self.column_names
        files = self.plan_files()
        parts: List[pa.Table] = []
        for f in files:
            t = self._read_file(f)
            missing = [c for c in cols if c not in t.column_names]
            if missing:
                raise ValueError(
                    f"data file {f.file_path} lacks columns {missing}")
            parts.append(t.select(cols))
        if not parts:
            return pa.table({c: pa.array([]) for c in cols})
        out = pa.concat_tables(parts, promote_options="permissive")
        total = sum(f.record_count for f in files)
        if out.num_rows != total:
            raise ValueError(
                f"manifest record_count {total} != rows read "
                f"{out.num_rows}")
        return out

    def _read_file(self, f: IcebergDataFile) -> pa.Table:
        data = self.file_io.read_bytes(f.file_path)
        buf = pa.BufferReader(data)
        if f.file_format == "parquet":
            import pyarrow.parquet as pq
            return pq.read_table(buf)
        if f.file_format == "orc":
            import pyarrow.orc as orc
            return orc.ORCFile(buf).read()
        if f.file_format == "avro":
            _, recs = avro_fmt.read_container(data)
            return pa.Table.from_pylist(recs)
        raise ValueError(f"unsupported data format {f.file_format}")
