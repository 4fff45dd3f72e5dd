"""ManifestFile and ManifestList readers/writers (avro object files).

reference: paimon-core/.../manifest/ManifestFile.java, ManifestList.java,
ManifestFileMeta.java; spec manifest.md.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from paimon_tpu_torch.format import avro as avro_fmt
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest.manifest_entry import (
    MANIFEST_ENTRY_AVRO_SCHEMA, FileKind, ManifestEntry,
)
from paimon_tpu_torch.manifest.simple_stats import SimpleStats

__all__ = ["ManifestFile", "ManifestFileMeta", "ManifestList"]

META_VERSION = 2


@dataclass
class ManifestFileMeta:
    file_name: str
    file_size: int
    num_added_files: int
    num_deleted_files: int
    partition_stats: SimpleStats
    schema_id: int
    min_row_id: Optional[int] = None
    max_row_id: Optional[int] = None
    # manifest-level pruning stats (ours; feed the columnar stats
    # sidecar — manifest/stats_sidecar.py): bucket range and the
    # trimmed-primary-key min/max (BinaryRow bytes, compared decoded)
    # over every entry in the manifest.  Optional so old manifests
    # round-trip; None disables the corresponding vectorized prune.
    min_bucket: Optional[int] = None
    max_bucket: Optional[int] = None
    min_key: Optional[bytes] = None
    max_key: Optional[bytes] = None

    def to_avro(self) -> dict:
        return {
            "_VERSION": META_VERSION,
            "_FILE_NAME": self.file_name,
            "_FILE_SIZE": self.file_size,
            "_NUM_ADDED_FILES": self.num_added_files,
            "_NUM_DELETED_FILES": self.num_deleted_files,
            "_PARTITION_STATS": self.partition_stats.to_avro(),
            "_SCHEMA_ID": self.schema_id,
            "_MIN_ROW_ID": self.min_row_id,
            "_MAX_ROW_ID": self.max_row_id,
            "_MIN_BUCKET": self.min_bucket,
            "_MAX_BUCKET": self.max_bucket,
            "_MIN_KEY": self.min_key,
            "_MAX_KEY": self.max_key,
        }

    @staticmethod
    def from_avro(d: dict) -> "ManifestFileMeta":
        min_key = d.get("_MIN_KEY")
        max_key = d.get("_MAX_KEY")
        return ManifestFileMeta(
            file_name=d["_FILE_NAME"],
            file_size=d["_FILE_SIZE"],
            num_added_files=d["_NUM_ADDED_FILES"],
            num_deleted_files=d["_NUM_DELETED_FILES"],
            partition_stats=SimpleStats.from_avro(d["_PARTITION_STATS"]),
            schema_id=d["_SCHEMA_ID"],
            min_row_id=d.get("_MIN_ROW_ID"),
            max_row_id=d.get("_MAX_ROW_ID"),
            min_bucket=d.get("_MIN_BUCKET"),
            max_bucket=d.get("_MAX_BUCKET"),
            min_key=bytes(min_key) if min_key is not None else None,
            max_key=bytes(max_key) if max_key is not None else None,
        )


MANIFEST_FILE_META_AVRO_SCHEMA = {
    "type": "record",
    "name": "ManifestFileMeta",
    "fields": [
        {"name": "_VERSION", "type": "int"},
        {"name": "_FILE_NAME", "type": "string"},
        {"name": "_FILE_SIZE", "type": "long"},
        {"name": "_NUM_ADDED_FILES", "type": "long"},
        {"name": "_NUM_DELETED_FILES", "type": "long"},
        {"name": "_PARTITION_STATS", "type": {
            "type": "record", "name": "record_PARTITION_STATS", "fields": [
                {"name": "_MIN_VALUES", "type": "bytes"},
                {"name": "_MAX_VALUES", "type": "bytes"},
                {"name": "_NULL_COUNTS",
                 "type": ["null", {"type": "array",
                                   "items": ["null", "long"]}],
                 "default": None},
            ]}},
        {"name": "_SCHEMA_ID", "type": "long"},
        {"name": "_MIN_ROW_ID", "type": ["null", "long"], "default": None},
        {"name": "_MAX_ROW_ID", "type": ["null", "long"], "default": None},
        {"name": "_MIN_BUCKET", "type": ["null", "int"], "default": None},
        {"name": "_MAX_BUCKET", "type": ["null", "int"], "default": None},
        {"name": "_MIN_KEY", "type": ["null", "bytes"], "default": None},
        {"name": "_MAX_KEY", "type": ["null", "bytes"], "default": None},
    ],
}


class ManifestFile:
    """Reads/writes manifest-<uuid>-<n> files under <table>/manifest/."""

    def __init__(self, file_io: FileIO, manifest_dir: str,
                 compression: str = "zstandard",
                 partition_types: Optional[list] = None,
                 key_types: Optional[list] = None,
                 sidecar: bool = True):
        self.file_io = file_io
        self.manifest_dir = manifest_dir.rstrip("/")
        self.compression = compression
        self.partition_types = partition_types or []
        # trimmed-primary-key types: enables per-manifest key-range
        # stats (min/max over every entry's file key stats).  The
        # stats' only consumer is the columnar sidecar — when it is
        # disabled, skip the two-BinaryRow-decodes-per-entry work on
        # the commit hot path
        self.key_types = key_types or []
        self.sidecar = sidecar
        self._suffix = 0

    def new_file_name(self) -> str:
        name = f"manifest-{uuid.uuid4()}-{self._suffix}"
        self._suffix += 1
        return name

    def path(self, name: str) -> str:
        return f"{self.manifest_dir}/{name}"

    def write(self, entries: Sequence[ManifestEntry],
              schema_id: int = 0) -> ManifestFileMeta:
        name = self.new_file_name()
        data = avro_fmt.write_container(
            MANIFEST_ENTRY_AVRO_SCHEMA, [e.to_avro() for e in entries],
            codec=self.compression)
        self.file_io.write_bytes(self.path(name), data, overwrite=False)
        num_added = sum(1 for e in entries if e.kind == FileKind.ADD)
        num_deleted = len(entries) - num_added
        min_bucket = min((e.bucket for e in entries), default=None)
        max_bucket = max((e.bucket for e in entries), default=None)
        min_key, max_key = self._key_range(entries) \
            if self.sidecar else (None, None)
        return ManifestFileMeta(
            file_name=name,
            file_size=len(data),
            num_added_files=num_added,
            num_deleted_files=num_deleted,
            partition_stats=self._partition_stats(entries),
            schema_id=schema_id,
            min_bucket=min_bucket,
            max_bucket=max_bucket,
            min_key=min_key,
            max_key=max_key,
        )

    def read(self, name: str) -> List[ManifestEntry]:
        _, records = avro_fmt.read_container(
            self.file_io.read_bytes(self.path(name)))
        return [ManifestEntry.from_avro(r) for r in records]

    def delete(self, name: str):
        self.file_io.delete_quietly(self.path(name))

    def _key_range(self, entries: Sequence[ManifestEntry]
                   ) -> Tuple[Optional[bytes], Optional[bytes]]:
        """Min/max trimmed-primary-key over every entry's file key
        stats, compared DECODED (BinaryRow bytes are little-endian
        slots, not order-comparable), returned as the winning rows'
        raw bytes.  None on any undecodable key — stats are advisory
        and the vectorized prune keeps unconstrained manifests."""
        if not self.key_types or not entries:
            return None, None
        from paimon_tpu_torch.data.binary_row import BinaryRowCodec
        codec = BinaryRowCodec([t.copy(False) for t in self.key_types])
        best_min = best_max = None          # (decoded tuple, raw bytes)
        try:
            for e in entries:
                mk, xk = e.file.min_key, e.file.max_key
                if not mk or not xk:
                    return None, None
                lo = tuple(codec.from_bytes(mk))
                hi = tuple(codec.from_bytes(xk))
                if best_min is None or lo < best_min[0]:
                    best_min = (lo, mk)
                if best_max is None or hi > best_max[0]:
                    best_max = (hi, xk)
        except Exception:                   # noqa: BLE001 — advisory
            return None, None
        return best_min[1], best_max[1]

    def _partition_stats(self,
                         entries: Sequence[ManifestEntry]) -> SimpleStats:
        if not self.partition_types or not entries:
            return SimpleStats.EMPTY
        from paimon_tpu_torch.data.binary_row import BinaryRowCodec
        codec = BinaryRowCodec(self.partition_types)
        arity = len(self.partition_types)
        mins = [None] * arity
        maxs = [None] * arity
        nulls = [0] * arity
        for e in entries:
            values = codec.from_bytes(e.partition)
            for i, v in enumerate(values):
                if v is None:
                    nulls[i] += 1
                    continue
                if mins[i] is None or v < mins[i]:
                    mins[i] = v
                if maxs[i] is None or v > maxs[i]:
                    maxs[i] = v
        return SimpleStats(codec.to_bytes(mins), codec.to_bytes(maxs), nulls)


class ManifestList:
    """Reads/writes manifest-list-<uuid>-<n> files.

    With `sidecar=True` every written list also gets a `stats-<name>`
    columnar sidecar (manifest/stats_sidecar.py) that scan planning
    prunes against, vectorised, before fetching any manifest file."""

    def __init__(self, file_io: FileIO, manifest_dir: str,
                 compression: str = "zstandard",
                 partition_types: Optional[list] = None,
                 key_types: Optional[list] = None,
                 sidecar: bool = False):
        self.file_io = file_io
        self.manifest_dir = manifest_dir.rstrip("/")
        self.compression = compression
        self.partition_types = partition_types or []
        self.key_types = key_types or []
        self.sidecar = sidecar
        self._suffix = 0

    def new_file_name(self) -> str:
        name = f"manifest-list-{uuid.uuid4()}-{self._suffix}"
        self._suffix += 1
        return name

    def path(self, name: str) -> str:
        return f"{self.manifest_dir}/{name}"

    def write(self, metas: Sequence[ManifestFileMeta]) -> Tuple[str, int]:
        name = self.new_file_name()
        data = avro_fmt.write_container(
            MANIFEST_FILE_META_AVRO_SCHEMA, [m.to_avro() for m in metas],
            codec=self.compression)
        self.file_io.write_bytes(self.path(name), data, overwrite=False)
        if self.sidecar and metas:
            from paimon_tpu_torch.manifest.stats_sidecar import (
                build_sidecar, sidecar_path,
            )
            from paimon_tpu_torch.utils.deadline import DeadlineExceededError
            try:
                blob = build_sidecar(metas, self.partition_types,
                                     self.key_types)
                if blob is not None:
                    self.file_io.write_bytes(
                        sidecar_path(self.path(name)), blob,
                        overwrite=False)
            except (DeadlineExceededError, KeyboardInterrupt,
                    SystemExit):
                # a genuine abort: the caller treats this write as
                # failed, so the list it already wrote is unrecorded and
                # must go with it
                self.file_io.delete_quietly(self.path(name))
                raise
            except Exception:               # noqa: BLE001 — advisory
                # readers fall back to the Python prune without a
                # sidecar, so a failed build or write never fails a
                # commit whose required files all landed; sweep a torn
                # blob and go on without one
                self.file_io.delete_quietly(
                    sidecar_path(self.path(name)))
        return name, len(data)

    def read(self, name: str) -> List[ManifestFileMeta]:
        _, records = avro_fmt.read_container(
            self.file_io.read_bytes(self.path(name)))
        return [ManifestFileMeta.from_avro(r) for r in records]

    def read_sidecar(self, name: str):
        """The columnar stats sidecar of one list (an Arrow table), or
        None when absent or undecodable."""
        from paimon_tpu_torch.manifest.stats_sidecar import read_sidecar
        return read_sidecar(self.file_io, self.path(name))

    def read_all(self, base_name: str,
                 delta_name: Optional[str]) -> List[ManifestFileMeta]:
        out = self.read(base_name) if base_name else []
        if delta_name:
            out.extend(self.read(delta_name))
        return out

    def delete(self, name: str):
        from paimon_tpu_torch.manifest.stats_sidecar import sidecar_path
        self.file_io.delete_quietly(self.path(name))
        self.file_io.delete_quietly(sidecar_path(self.path(name)))
