"""Index manifest: table-index files (dynamic-bucket hash index,
deletion vectors).

reference: paimon-core/.../manifest/IndexManifestFile.java,
index/IndexFileMeta.java; spec manifest.md "Index Manifest".
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from paimon_tpu_torch.format import avro as avro_fmt
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest.manifest_entry import FileKind

__all__ = ["IndexFileMeta", "IndexManifestEntry", "IndexManifestFile",
           "HASH_INDEX", "DELETION_VECTORS_INDEX"]

HASH_INDEX = "HASH"
DELETION_VECTORS_INDEX = "DELETION_VECTORS"


@dataclass
class IndexFileMeta:
    index_type: str
    file_name: str
    file_size: int
    row_count: int
    # file name -> (offset, length, cardinality) for DELETION_VECTORS
    dv_ranges: Optional[Dict[str, Tuple[int, int, int]]] = None


@dataclass
class IndexManifestEntry:
    kind: int            # FileKind
    partition: bytes
    bucket: int
    index_file: IndexFileMeta

    def to_avro(self) -> dict:
        dv = None
        if self.index_file.dv_ranges is not None:
            dv = [{"f0": k, "f1": v[0], "f2": v[1], "_CARDINALITY": v[2]}
                  for k, v in self.index_file.dv_ranges.items()]
        return {
            "_VERSION": 1,
            "_KIND": self.kind,
            "_PARTITION": self.partition,
            "_BUCKET": self.bucket,
            "_INDEX_TYPE": self.index_file.index_type,
            "_FILE_NAME": self.index_file.file_name,
            "_FILE_SIZE": self.index_file.file_size,
            "_ROW_COUNT": self.index_file.row_count,
            "_DELETIONS_VECTORS_RANGES": dv,
        }

    @staticmethod
    def from_avro(d: dict) -> "IndexManifestEntry":
        dv = None
        if d.get("_DELETIONS_VECTORS_RANGES") is not None:
            dv = {r["f0"]: (r["f1"], r["f2"], r.get("_CARDINALITY", -1))
                  for r in d["_DELETIONS_VECTORS_RANGES"]}
        return IndexManifestEntry(
            kind=d["_KIND"],
            partition=bytes(d["_PARTITION"]),
            bucket=d["_BUCKET"],
            index_file=IndexFileMeta(
                index_type=d["_INDEX_TYPE"],
                file_name=d["_FILE_NAME"],
                file_size=d["_FILE_SIZE"],
                row_count=d["_ROW_COUNT"],
                dv_ranges=dv,
            ))


INDEX_MANIFEST_AVRO_SCHEMA = {
    "type": "record",
    "name": "IndexManifestEntry",
    "fields": [
        {"name": "_VERSION", "type": "int"},
        {"name": "_KIND", "type": "int"},
        {"name": "_PARTITION", "type": "bytes"},
        {"name": "_BUCKET", "type": "int"},
        {"name": "_INDEX_TYPE", "type": "string"},
        {"name": "_FILE_NAME", "type": "string"},
        {"name": "_FILE_SIZE", "type": "long"},
        {"name": "_ROW_COUNT", "type": "long"},
        {"name": "_DELETIONS_VECTORS_RANGES",
         "type": ["null", {"type": "array", "items": {
             "type": "record", "name": "DeletionVectorMeta", "fields": [
                 {"name": "f0", "type": "string"},
                 {"name": "f1", "type": "int"},
                 {"name": "f2", "type": "int"},
                 {"name": "_CARDINALITY", "type": ["null", "long"],
                  "default": None},
             ]}}],
         "default": None},
    ],
}


class IndexManifestFile:
    """Reads/writes index-manifest-<uuid>-<n> files. Each snapshot's index
    manifest is the FULL current set of index files (merged)."""

    def __init__(self, file_io: FileIO, manifest_dir: str,
                 compression: str = "zstandard"):
        self.file_io = file_io
        self.manifest_dir = manifest_dir.rstrip("/")
        self.compression = compression

    def path(self, name: str) -> str:
        return f"{self.manifest_dir}/{name}"

    def write(self, entries: Sequence[IndexManifestEntry]) -> str:
        name = f"index-manifest-{uuid.uuid4()}-0"
        data = avro_fmt.write_container(
            INDEX_MANIFEST_AVRO_SCHEMA, [e.to_avro() for e in entries],
            codec=self.compression)
        self.file_io.write_bytes(self.path(name), data, overwrite=False)
        return name

    def read(self, name: str) -> List[IndexManifestEntry]:
        _, records = avro_fmt.read_container(
            self.file_io.read_bytes(self.path(name)))
        return [IndexManifestEntry.from_avro(r) for r in records]

    def combine(self, previous_name: Optional[str],
                new_entries: Sequence[IndexManifestEntry]) -> Optional[str]:
        """Merge previous index manifest with new ADD/DELETE entries and
        write the combined manifest (reference
        IndexManifestFile.writeIndexFiles)."""
        if not new_entries:
            return previous_name
        live: Dict[Tuple, IndexManifestEntry] = {}
        if previous_name:
            for e in self.read(previous_name):
                live[(e.partition, e.bucket, e.index_file.index_type,
                      e.index_file.file_name)] = e
        for e in new_entries:
            key = (e.partition, e.bucket, e.index_file.index_type,
                   e.index_file.file_name)
            if e.kind == FileKind.ADD:
                live[key] = e
            else:
                live.pop(key, None)
        return self.write(list(live.values()))
