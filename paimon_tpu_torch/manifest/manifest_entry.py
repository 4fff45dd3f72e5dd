"""ManifestEntry: ADD/DELETE of a data file in a (partition, bucket).

reference: paimon-core/.../manifest/ManifestEntry.java + FileEntry merge
logic (ManifestFileMerger): the same file may be added then deleted across
manifests; the last state wins, and a DELETE cancels its ADD.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

from paimon_tpu_torch.manifest.data_file_meta import (
    DATA_FILE_META_AVRO_SCHEMA, DataFileMeta,
)

__all__ = ["FileKind", "ManifestEntry", "merge_manifest_entries",
           "MANIFEST_ENTRY_AVRO_SCHEMA"]

ENTRY_VERSION = 2


class FileKind:
    ADD = 0
    DELETE = 1


@dataclass
class ManifestEntry:
    kind: int                 # FileKind
    partition: bytes          # BinaryRow of partition values
    bucket: int
    total_buckets: int
    file: DataFileMeta

    def identifier(self) -> Tuple:
        """Unique id of the file within the table
        (reference FileEntry.identifier)."""
        return (self.partition, self.bucket, self.file.level,
                self.file.file_name, tuple(self.file.extra_files),
                self.file.embedded_index, self.file.external_path)

    def to_avro(self) -> dict:
        return {
            "_VERSION": ENTRY_VERSION,
            "_KIND": self.kind,
            "_PARTITION": self.partition,
            "_BUCKET": self.bucket,
            "_TOTAL_BUCKETS": self.total_buckets,
            "_FILE": self.file.to_avro(),
        }

    @staticmethod
    def from_avro(d: dict) -> "ManifestEntry":
        return ManifestEntry(
            kind=d["_KIND"],
            partition=bytes(d["_PARTITION"]),
            bucket=d["_BUCKET"],
            total_buckets=d["_TOTAL_BUCKETS"],
            file=DataFileMeta.from_avro(d["_FILE"]),
        )


MANIFEST_ENTRY_AVRO_SCHEMA = {
    "type": "record",
    "name": "ManifestEntry",
    "fields": [
        {"name": "_VERSION", "type": "int"},
        {"name": "_KIND", "type": "int"},
        {"name": "_PARTITION", "type": "bytes"},
        {"name": "_BUCKET", "type": "int"},
        {"name": "_TOTAL_BUCKETS", "type": "int"},
        {"name": "_FILE", "type": DATA_FILE_META_AVRO_SCHEMA},
    ],
}


def merge_manifest_entries(
        entries: Iterable[ManifestEntry]) -> List[ManifestEntry]:
    """Collapse ADD/DELETE history: keep live files only
    (reference manifest/FileEntry.mergeEntries)."""
    live: Dict[Tuple, ManifestEntry] = {}
    for e in entries:
        ident = e.identifier()
        if e.kind == FileKind.ADD:
            live[ident] = e
        else:
            if ident in live:
                del live[ident]
            else:
                # DELETE of a file added in an older base: keep the delete
                # so downstream merging can cancel it.
                live[ident] = e
    return list(live.values())
