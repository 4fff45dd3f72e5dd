"""DataFileMeta: metadata of one data/changelog file.

reference: paimon-core/.../io/DataFileMeta.java:60 (367 lines) and the avro
wire schema in spec manifest.md (18 fields, _FILE_NAME ... _EXTERNAL_PATH).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field, replace
from typing import List, Optional

from paimon_tpu_torch.manifest.simple_stats import SimpleStats

__all__ = ["DataFileMeta", "FileSource"]


class FileSource:
    APPEND = 0
    COMPACT = 1


@dataclass
class DataFileMeta:
    file_name: str
    file_size: int
    row_count: int
    min_key: bytes            # BinaryRow of trimmed pk
    max_key: bytes
    key_stats: SimpleStats
    value_stats: SimpleStats
    min_sequence_number: int
    max_sequence_number: int
    schema_id: int
    level: int
    extra_files: List[str] = field(default_factory=list)
    creation_time: Optional[int] = None        # epoch millis
    delete_row_count: Optional[int] = None
    embedded_index: Optional[bytes] = None
    file_source: Optional[int] = FileSource.APPEND
    value_stats_cols: Optional[List[str]] = None
    external_path: Optional[str] = None
    first_row_id: Optional[int] = None
    write_cols: Optional[List[str]] = None

    def __post_init__(self):
        if self.creation_time is None:
            self.creation_time = int(_time.time() * 1000)

    @property
    def add_row_count(self) -> int:
        return self.row_count - (self.delete_row_count or 0)

    def upgrade(self, new_level: int) -> "DataFileMeta":
        """Metadata-only level promotion (reference DataFileMeta.upgrade)."""
        return replace(self, level=new_level)

    def rename(self, new_name: str) -> "DataFileMeta":
        return replace(self, file_name=new_name)

    def copy_without_stats(self) -> "DataFileMeta":
        return replace(self, value_stats=SimpleStats.EMPTY,
                       value_stats_cols=[])

    # -- avro wire -----------------------------------------------------------

    def to_avro(self) -> dict:
        return {
            "_FILE_NAME": self.file_name,
            "_FILE_SIZE": self.file_size,
            "_ROW_COUNT": self.row_count,
            "_MIN_KEY": self.min_key,
            "_MAX_KEY": self.max_key,
            "_KEY_STATS": self.key_stats.to_avro(),
            "_VALUE_STATS": self.value_stats.to_avro(),
            "_MIN_SEQUENCE_NUMBER": self.min_sequence_number,
            "_MAX_SEQUENCE_NUMBER": self.max_sequence_number,
            "_SCHEMA_ID": self.schema_id,
            "_LEVEL": self.level,
            "_EXTRA_FILES": self.extra_files,
            "_CREATION_TIME": self.creation_time,
            "_DELETE_ROW_COUNT": self.delete_row_count,
            "_EMBEDDED_FILE_INDEX": self.embedded_index,
            "_FILE_SOURCE": self.file_source,
            "_VALUE_STATS_COLS": self.value_stats_cols,
            "_EXTERNAL_PATH": self.external_path,
            "_FIRST_ROW_ID": self.first_row_id,
            "_WRITE_COLS": self.write_cols,
        }

    @staticmethod
    def from_avro(d: dict) -> "DataFileMeta":
        return DataFileMeta(
            file_name=d["_FILE_NAME"],
            file_size=d["_FILE_SIZE"],
            row_count=d["_ROW_COUNT"],
            min_key=bytes(d["_MIN_KEY"]),
            max_key=bytes(d["_MAX_KEY"]),
            key_stats=SimpleStats.from_avro(d["_KEY_STATS"]),
            value_stats=SimpleStats.from_avro(d["_VALUE_STATS"]),
            min_sequence_number=d["_MIN_SEQUENCE_NUMBER"],
            max_sequence_number=d["_MAX_SEQUENCE_NUMBER"],
            schema_id=d["_SCHEMA_ID"],
            level=d["_LEVEL"],
            extra_files=list(d.get("_EXTRA_FILES") or []),
            creation_time=d.get("_CREATION_TIME"),
            delete_row_count=d.get("_DELETE_ROW_COUNT"),
            embedded_index=(bytes(d["_EMBEDDED_FILE_INDEX"])
                            if d.get("_EMBEDDED_FILE_INDEX") is not None
                            else None),
            file_source=d.get("_FILE_SOURCE"),
            value_stats_cols=d.get("_VALUE_STATS_COLS"),
            external_path=d.get("_EXTERNAL_PATH"),
            first_row_id=d.get("_FIRST_ROW_ID"),
            write_cols=d.get("_WRITE_COLS"),
        )


DATA_FILE_META_AVRO_SCHEMA = {
    "type": "record",
    "name": "DataFileMeta",
    "fields": [
        {"name": "_FILE_NAME", "type": "string"},
        {"name": "_FILE_SIZE", "type": "long"},
        {"name": "_ROW_COUNT", "type": "long"},
        {"name": "_MIN_KEY", "type": "bytes"},
        {"name": "_MAX_KEY", "type": "bytes"},
        {"name": "_KEY_STATS", "type": {
            "type": "record", "name": "record_KEY_STATS", "fields": [
                {"name": "_MIN_VALUES", "type": "bytes"},
                {"name": "_MAX_VALUES", "type": "bytes"},
                {"name": "_NULL_COUNTS",
                 "type": ["null", {"type": "array",
                                   "items": ["null", "long"]}],
                 "default": None},
            ]}},
        {"name": "_VALUE_STATS", "type": {
            "type": "record", "name": "record_VALUE_STATS", "fields": [
                {"name": "_MIN_VALUES", "type": "bytes"},
                {"name": "_MAX_VALUES", "type": "bytes"},
                {"name": "_NULL_COUNTS",
                 "type": ["null", {"type": "array",
                                   "items": ["null", "long"]}],
                 "default": None},
            ]}},
        {"name": "_MIN_SEQUENCE_NUMBER", "type": "long"},
        {"name": "_MAX_SEQUENCE_NUMBER", "type": "long"},
        {"name": "_SCHEMA_ID", "type": "long"},
        {"name": "_LEVEL", "type": "int"},
        {"name": "_EXTRA_FILES", "type": {"type": "array",
                                          "items": "string"}},
        {"name": "_CREATION_TIME",
         "type": ["null", {"type": "long",
                           "logicalType": "timestamp-millis"}],
         "default": None},
        {"name": "_DELETE_ROW_COUNT", "type": ["null", "long"],
         "default": None},
        {"name": "_EMBEDDED_FILE_INDEX", "type": ["null", "bytes"],
         "default": None},
        {"name": "_FILE_SOURCE", "type": ["null", "int"], "default": None},
        {"name": "_VALUE_STATS_COLS",
         "type": ["null", {"type": "array", "items": "string"}],
         "default": None},
        {"name": "_EXTERNAL_PATH", "type": ["null", "string"],
         "default": None},
        {"name": "_FIRST_ROW_ID", "type": ["null", "long"], "default": None},
        {"name": "_WRITE_COLS",
         "type": ["null", {"type": "array", "items": "string"}],
         "default": None},
    ],
}
