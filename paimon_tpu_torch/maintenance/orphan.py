"""Orphan-file cleanup.

reference: operation/OrphanFilesClean.java / LocalOrphanFilesClean: files
in the table directory referenced by NO snapshot/tag/branch and older
than a grace period (default 1 day, guards in-flight writers) are
deleted.

`incremental=True` rides the watermark the last clean sweep stamped
(maintenance/watermark.py, `maintenance.orphan.watermark.*`): its `ts`
records the grace CUTOFF below which every file on storage was proven
referenced-or-deleted.  The next sweep then only considers files
NEWER than that horizon, and — because snapshot files are immutable
and a data/manifest file is always written before the commit that
references it — only snapshots committed at/after the horizon can
reference such a file, so the referenced-set walk is O(delta) too.
A rollback_to / fast_forward that recreates the stamped snapshot id
invalidates the watermark (list-name mismatch, mirroring the plan
cache's `matches_tip`) and the sweep silently runs full.  Orphans
OLDER than the horizon that appear later (a crash mid-expire
stranding files the last sweep saw referenced) are only found by a
full pass — run one periodically as the oracle.

Counterpart of paimon_tpu/maintenance/orphan.py: the same sweep and
watermark properties.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional, Set

from paimon_tpu_torch.snapshot import SnapshotManager

__all__ = ["remove_orphan_files"]

_META_DIRS = {"snapshot", "schema", "manifest", "tag", "branch", "consumer",
              "statistics"}
DEFAULT_OLDER_THAN_MS = 24 * 3600 * 1000


def _all_snapshots(table):
    sm = table.snapshot_manager
    out = list(sm.snapshots())
    out.extend(table.tag_manager.tagged_snapshots())
    for b in table.branch_manager.branches():
        bsm = SnapshotManager(table.file_io, table.path, branch=b)
        out.extend(bsm.snapshots())
    return out


def _walk_files(file_io, root: str, out: List):
    out.extend(file_io.list_status_recursive(root))


def remove_orphan_files(table, older_than_ms: Optional[int] = None,
                        dry_run: bool = False,
                        now_ms: Optional[int] = None,
                        incremental: bool = False) -> List[str]:
    """Delete unreferenced data/manifest/index files older than the
    grace period. Returns the deleted paths.

    `older_than_ms` is the ABSOLUTE cutoff (files modified at or after
    it survive); when omitted it derives from `now_ms` (injectable
    clock, defaults to wall time) minus the one-day grace period that
    protects in-flight writers.

    `incremental=True` restricts both the candidate walk and the
    referenced-set computation to files/snapshots newer than the last
    clean sweep's horizon (module docstring), and stamps a new
    watermark after a successful non-dry sweep."""
    if now_ms is None:
        now_ms = int(_time.time() * 1000)
    cutoff = (now_ms - DEFAULT_OLDER_THAN_MS) \
        if older_than_ms is None else older_than_ms

    floor_ms = None
    if incremental:
        from paimon_tpu_torch.maintenance.watermark import (
            ORPHAN_WATERMARK_PREFIX, read_watermark,
            validate_watermark,
        )
        wm = read_watermark(table, ORPHAN_WATERMARK_PREFIX)
        if wm is not None and validate_watermark(table, wm):
            floor_ms = wm.ts_ms

    from paimon_tpu_torch.maintenance.expire import _snapshot_refs
    referenced: Set[str] = set()
    for snap in _all_snapshots(table):
        if floor_ms is not None and snap.time_millis < floor_ms - 1000:
            # committed before the verified horizon: can only
            # reference files older than it, none of which are
            # candidates this sweep (1s slack absorbs coarse fs
            # mtime granularity vs. the commit clock)
            continue
        data, manifests = _snapshot_refs(table, snap)
        referenced |= {fname for (_, _, fname, _ext) in data}
        referenced |= manifests

    candidates = []
    for st in table.file_io.list_status(table.path):
        base = st.path.rstrip("/").split("/")[-1]
        if not st.is_dir:
            continue
        if base in _META_DIRS:
            if base != "manifest":
                continue
        _walk_files(table.file_io, st.path, candidates)
    # external data roots are part of the table's storage footprint:
    # un-committed writer leftovers there must be reclaimed too
    # (reference OrphanFilesClean walks dataFileExternalPaths)
    from paimon_tpu_torch.options import CoreOptions
    ext = table.options.get(CoreOptions.DATA_FILE_EXTERNAL_PATHS)
    strategy = table.options.get(
        CoreOptions.DATA_FILE_EXTERNAL_PATHS_STRATEGY)
    if ext and strategy and strategy != "NONE":
        for root in ext.split(","):
            root = root.strip().rstrip("/")
            if root:
                try:
                    _walk_files(table.file_io, root, candidates)
                except FileNotFoundError:
                    pass

    deleted = []
    for st in candidates:
        fname = st.path.rstrip("/").split("/")[-1]
        if fname in referenced:
            continue
        if st.mtime_ms and st.mtime_ms >= cutoff:
            continue
        if floor_ms is not None and st.mtime_ms and \
                st.mtime_ms < floor_ms:
            continue        # proven referenced-or-deleted last sweep
        deleted.append(st.path)
        if not dry_run:
            table.file_io.delete_quietly(st.path)

    if incremental and not dry_run:
        # record the new horizon: everything below THIS run's cutoff
        # is now proven referenced-or-deleted
        from paimon_tpu_torch.maintenance.watermark import (
            ORPHAN_WATERMARK_PREFIX, stamp_watermark,
        )
        stamp_watermark(table, ORPHAN_WATERMARK_PREFIX, ts_ms=cutoff,
                        commit_user="orphan-sweep")
    return deleted
