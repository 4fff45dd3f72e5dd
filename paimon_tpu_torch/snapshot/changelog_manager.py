"""Decoupled long-lived changelog.

reference: paimon-core/src/main/java/org/apache/paimon/utils/
ChangelogManager.java + Changelog.java: changelog retention can outlive
snapshot retention — when an expiring snapshot carries changelog, its
metadata is preserved under `changelog/changelog-<id>` so the changelog
files stay readable for stream consumers long after the snapshot (and
its data files) are gone.  `changelog.num-retained.{min,max}` bound
the decoupled set; an expire pass deletes the oldest entries together
with their changelog files.  `changelog.time-retained` is read by no
expiry of either package, so the port refuses it (ROADMAP.md A.8.4b).

A copy of paimon_tpu/snapshot/changelog_manager.py (no JAX in it).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.snapshot.snapshot import Snapshot

__all__ = ["ChangelogManager"]

CHANGELOG_PREFIX = "changelog-"
EARLIEST = "EARLIEST"
LATEST = "LATEST"


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

    # -- reads ---------------------------------------------------------------

    def changelog(self, changelog_id: int) -> Snapshot:
        return Snapshot.from_json(self.file_io.read_utf8(
            self.changelog_path(changelog_id)))

    def try_changelog(self, changelog_id: int) -> Optional[Snapshot]:
        try:
            return self.changelog(changelog_id)
        except (FileNotFoundError, OSError):
            return None

    def _ids(self) -> List[int]:
        try:
            names = self.file_io.list_files(self.changelog_dir)
        except (FileNotFoundError, OSError):
            return []
        out = []
        for n in names:
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

    def latest_changelog_id(self) -> Optional[int]:
        ids = self._ids()
        return ids[-1] if ids else None

    def changelogs(self) -> Iterator[Snapshot]:
        for cid in self._ids():
            snap = self.try_changelog(cid)
            if snap is not None:
                yield snap

    # -- writes --------------------------------------------------------------

    def commit_changelog(self, snapshot: Snapshot) -> bool:
        """Preserve an expiring snapshot's changelog metadata (reference
        ChangelogManager.commitChangelog)."""
        path = self.changelog_path(snapshot.id)
        if self.file_io.exists(path):
            return False
        return self.file_io.try_to_write_atomic(
            path, snapshot.to_json().encode("utf-8"))

    def delete_changelog(self, changelog_id: int):
        self.file_io.delete_quietly(self.changelog_path(changelog_id))
