"""BranchManager: isolated dev branches under ``branch/branch-<name>/``.

reference: paimon-core/.../utils/BranchManager.java +
FileSystemBranchManager: a branch copies the source schema + optionally a
tagged snapshot, then evolves its own snapshot/ and schema/ dirs;
fast-forward replays branch snapshots onto main.

A copy of paimon_tpu/snapshot/branch_manager.py (no JAX in it); the
branch layout is the reference's.  One difference: `fast_forward`
re-points main's EARLIEST hint at its earliest snapshot, which the
reference leaves on a deleted one when main's snapshots were expired
past the branch's start.
"""

from __future__ import annotations

from typing import List, Optional

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.snapshot.snapshot import Snapshot

__all__ = ["BranchManager"]

BRANCH_PREFIX = "branch-"
DEFAULT_MAIN_BRANCH = "main"


class BranchManager:
    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")

    @property
    def branch_dir(self) -> str:
        return f"{self.table_path}/branch"

    def branch_path(self, name: str) -> str:
        return f"{self.branch_dir}/{BRANCH_PREFIX}{name}"

    def branch_exists(self, name: str) -> bool:
        if name == DEFAULT_MAIN_BRANCH:
            return True
        return self.file_io.exists(self.branch_path(name))

    def branches(self) -> List[str]:
        out = []
        for st in self.file_io.list_status(self.branch_dir):
            fname = st.path.rstrip("/").split("/")[-1]
            if fname.startswith(BRANCH_PREFIX):
                out.append(fname[len(BRANCH_PREFIX):])
        return sorted(out)

    def create_branch(self, name: str,
                      from_snapshot: Optional[Snapshot] = None,
                      schema_json: Optional[str] = None):
        """Create branch, copying latest schema (and optionally pinning a
        snapshot as the branch's first)."""
        if name == DEFAULT_MAIN_BRANCH or self.branch_exists(name):
            raise ValueError(f"Branch {name!r} already exists")
        root = self.branch_path(name)
        if schema_json is None:
            # copy latest schema from main
            from paimon_tpu_torch.schema.schema_manager import SchemaManager
            sm = SchemaManager(self.file_io, self.table_path)
            latest = sm.latest()
            if latest is None:
                raise ValueError("Cannot branch a table with no schema")
            schema_json = latest.to_json()
            schema_id = latest.id
        else:
            import json as _json
            schema_id = _json.loads(schema_json)["id"]
        self.file_io.write_bytes(f"{root}/schema/schema-{schema_id}",
                                 schema_json.encode("utf-8"),
                                 overwrite=False)
        if from_snapshot is not None:
            self.file_io.write_bytes(
                f"{root}/snapshot/snapshot-{from_snapshot.id}",
                from_snapshot.to_json().encode("utf-8"), overwrite=False)
            self.file_io.write_utf8(f"{root}/snapshot/LATEST",
                                    str(from_snapshot.id))
            self.file_io.write_utf8(f"{root}/snapshot/EARLIEST",
                                    str(from_snapshot.id))

    def drop_branch(self, name: str):
        self.file_io.delete(self.branch_path(name), recursive=True)

    def rename_branch(self, old: str, new: str):
        """Directory rename preserving every branch file verbatim
        (reference RenameBranchProcedure)."""
        if old == DEFAULT_MAIN_BRANCH:
            raise ValueError("cannot rename the main branch")
        if not self.branch_exists(old):
            raise ValueError(f"Branch {old!r} not found")
        if new == DEFAULT_MAIN_BRANCH or self.branch_exists(new):
            raise ValueError(f"Branch {new!r} already exists")
        if not self.file_io.rename(self.branch_path(old),
                                   self.branch_path(new)):
            raise RuntimeError(f"renaming branch {old!r} failed")

    def fast_forward(self, name: str):
        """Replace main's snapshots with the branch's (reference
        BranchManager.fastForward)."""
        from paimon_tpu_torch.snapshot.snapshot_manager import SnapshotManager
        branch_sm = SnapshotManager(self.file_io, self.table_path,
                                    branch=name)
        main_sm = SnapshotManager(self.file_io, self.table_path)
        branch_earliest = branch_sm.earliest_snapshot_id()
        if branch_earliest is None:
            raise ValueError(f"Branch {name!r} has no snapshots")
        # delete main snapshots >= branch earliest, then copy branch files
        main_latest = main_sm.latest_snapshot_id()
        if main_latest is not None:
            for i in range(branch_earliest, main_latest + 1):
                main_sm.delete_snapshot(i)
        latest = None
        for snap in branch_sm.snapshots():
            self.file_io.write_bytes(main_sm.snapshot_path(snap.id),
                                     snap.to_json().encode("utf-8"))
            latest = snap.id
        if latest is not None:
            main_sm.commit_latest_hint(latest)
        # main's earliest snapshot may have been newer than the branch's
        # (expired past the tag the branch started from): its EARLIEST
        # hint would name a deleted snapshot, which the reference leaves
        # for fsck to report as bad-hint
        ids = main_sm._all_ids()
        if ids:
            main_sm.commit_earliest_hint(ids[0])
        # copy branch schemas not present on main
        from paimon_tpu_torch.schema.schema_manager import SchemaManager
        branch_schemas = SchemaManager(self.file_io, self.table_path,
                                       branch=name)
        main_schemas = SchemaManager(self.file_io, self.table_path)
        main_ids = set(main_schemas.list_all_ids())
        for sid in branch_schemas.list_all_ids():
            if sid not in main_ids:
                self.file_io.write_bytes(
                    main_schemas.schema_path(sid),
                    branch_schemas.schema(sid).to_json().encode("utf-8"))
