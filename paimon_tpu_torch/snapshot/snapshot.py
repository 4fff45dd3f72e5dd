"""Snapshot JSON model (version 3).

reference: paimon-api/.../Snapshot.java:43; spec snapshot.md (20 fields).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["Snapshot", "CommitKind", "BATCH_COMMIT_IDENTIFIER"]

CURRENT_VERSION = 3
BATCH_COMMIT_IDENTIFIER = 0x7FFFFFFFFFFFFFFF
LONG_MIN = -(1 << 63)


class CommitKind:
    APPEND = "APPEND"
    COMPACT = "COMPACT"
    OVERWRITE = "OVERWRITE"
    ANALYZE = "ANALYZE"


@dataclass
class Snapshot:
    id: int
    schema_id: int
    base_manifest_list: str
    delta_manifest_list: str
    commit_user: str
    commit_identifier: int
    commit_kind: str
    time_millis: int
    total_record_count: int = 0
    delta_record_count: int = 0
    version: int = CURRENT_VERSION
    base_manifest_list_size: Optional[int] = None
    delta_manifest_list_size: Optional[int] = None
    changelog_manifest_list: Optional[str] = None
    changelog_manifest_list_size: Optional[int] = None
    index_manifest: Optional[str] = None
    changelog_record_count: Optional[int] = None
    watermark: Optional[int] = None
    statistics: Optional[str] = None
    log_offsets: Optional[Dict[str, int]] = None
    properties: Optional[Dict[str, str]] = None
    next_row_id: Optional[int] = None
    operation: Optional[str] = None

    def to_json(self) -> str:
        d = {
            "version": self.version,
            "id": self.id,
            "schemaId": self.schema_id,
            "baseManifestList": self.base_manifest_list,
            "deltaManifestList": self.delta_manifest_list,
            "commitUser": self.commit_user,
            "commitIdentifier": self.commit_identifier,
            "commitKind": self.commit_kind,
            "timeMillis": self.time_millis,
            "totalRecordCount": self.total_record_count,
            "deltaRecordCount": self.delta_record_count,
        }
        opt = {
            "baseManifestListSize": self.base_manifest_list_size,
            "deltaManifestListSize": self.delta_manifest_list_size,
            "changelogManifestList": self.changelog_manifest_list,
            "changelogManifestListSize": self.changelog_manifest_list_size,
            "indexManifest": self.index_manifest,
            "changelogRecordCount": self.changelog_record_count,
            "watermark": self.watermark,
            "statistics": self.statistics,
            "logOffsets": self.log_offsets,
            "properties": self.properties,
            "nextRowId": self.next_row_id,
            "operation": self.operation,
        }
        for k, v in opt.items():
            if v is not None:
                d[k] = v
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "Snapshot":
        d = json.loads(s)
        return Snapshot(
            id=d["id"],
            schema_id=d["schemaId"],
            base_manifest_list=d["baseManifestList"],
            delta_manifest_list=d["deltaManifestList"],
            commit_user=d["commitUser"],
            commit_identifier=d["commitIdentifier"],
            commit_kind=d["commitKind"],
            time_millis=d["timeMillis"],
            total_record_count=d.get("totalRecordCount", 0),
            delta_record_count=d.get("deltaRecordCount", 0),
            version=d.get("version", CURRENT_VERSION),
            base_manifest_list_size=d.get("baseManifestListSize"),
            delta_manifest_list_size=d.get("deltaManifestListSize"),
            changelog_manifest_list=d.get("changelogManifestList"),
            changelog_manifest_list_size=d.get("changelogManifestListSize"),
            index_manifest=d.get("indexManifest"),
            changelog_record_count=d.get("changelogRecordCount"),
            watermark=d.get("watermark"),
            statistics=d.get("statistics"),
            log_offsets=d.get("logOffsets"),
            properties=d.get("properties"),
            next_row_id=d.get("nextRowId"),
            operation=d.get("operation"),
        )
