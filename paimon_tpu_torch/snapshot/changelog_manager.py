"""Decoupled long-lived changelog, read side.

Counterpart of paimon_tpu/snapshot/changelog_manager.py with the reads a
stream scan makes: when an expiring snapshot carried changelog, its
metadata lives on under `changelog/changelog-<id>`, so consumers read
its changelog files after the snapshot is gone.  Writing those entries
and expiring them (changelog.num-retained.*) wait for the maintenance
plane (ROADMAP.md: the remaining planes).

reference: paimon-core/src/main/java/org/apache/paimon/utils/
ChangelogManager.java + Changelog.java.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.snapshot.snapshot import Snapshot

__all__ = ["ChangelogManager"]

CHANGELOG_PREFIX = "changelog-"


class ChangelogManager:
    def __init__(self, file_io: FileIO, table_path: str,
                 branch: str = "main"):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")
        self.branch = branch or "main"

    @property
    def changelog_dir(self) -> str:
        if self.branch != "main":
            return (f"{self.table_path}/branch/branch-{self.branch}"
                    f"/changelog")
        return f"{self.table_path}/changelog"

    def changelog_path(self, changelog_id: int) -> str:
        return f"{self.changelog_dir}/{CHANGELOG_PREFIX}{changelog_id}"

    def changelog(self, changelog_id: int) -> Snapshot:
        return Snapshot.from_json(self.file_io.read_utf8(
            self.changelog_path(changelog_id)))

    def try_changelog(self, changelog_id: int) -> Optional[Snapshot]:
        try:
            return self.changelog(changelog_id)
        except (FileNotFoundError, OSError):
            return None

    def _ids(self) -> List[int]:
        out = []
        for n in self.file_io.list_files(self.changelog_dir):
            base = n.rsplit("/", 1)[-1]
            if base.startswith(CHANGELOG_PREFIX):
                try:
                    out.append(int(base[len(CHANGELOG_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def earliest_changelog_id(self) -> Optional[int]:
        ids = self._ids()
        return ids[0] if ids else None

    def changelogs(self) -> Iterator[Snapshot]:
        for cid in self._ids():
            snap = self.try_changelog(cid)
            if snap is not None:
                yield snap
