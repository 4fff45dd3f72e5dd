"""Manifest full-compaction: fold accumulated small delta manifests
into sorted, partition-clustered base manifests (reference Paimon's
manifest full-compaction).

Under continuous streaming commits the manifest chain accretes one
small delta manifest per snapshot; every cold plan then pays one GET
and one decode per manifest.  Once the chain holds
`manifest.full-compaction.threshold` manifests, this action rewrites
the merged live-entry set into size-bounded base manifests clustered
by (partition, bucket, key) — committed like any other metadata
rewrite through FileStoreCommit's CAS (crash-swept + fsck-clean like
every mutating op), so concurrent writers retry normally and the
delta-apply plan cache rides across it untouched (a COMPACT snapshot
with an empty delta folds as a no-op).

Counterpart of paimon_tpu/maintenance/manifest_compact.py without the
reference's `properties_provider` seam, which only the multi-host
maintenance plane passes (ROADMAP.md A.8.9).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["manifest_compaction_needed", "compact_manifests"]


def manifest_compaction_needed(table) -> bool:
    """Count trigger: the latest snapshot's manifest chain holds at
    least `manifest.full-compaction.threshold` SMALL manifest files —
    below half `manifest.target-file-size`, i.e. the delta manifests
    (and unmerged fragments) accumulated since the last full rewrite
    (None/0 disables).  Full-size base manifests a previous compaction
    wrote never count: a table big enough that its compacted base
    alone spans >= threshold files must not re-trigger a full chain
    rewrite on every maintenance tick."""
    from paimon_tpu_torch.options import CoreOptions
    threshold = table.options.get(
        CoreOptions.MANIFEST_FULL_COMPACTION_THRESHOLD)
    if not threshold:
        return False
    snapshot = table.latest_snapshot()
    if snapshot is None:
        return False
    scan = table.new_scan()
    metas = scan.manifest_list.read_all(snapshot.base_manifest_list,
                                        snapshot.delta_manifest_list)
    small_bound = table.options.get(
        CoreOptions.MANIFEST_TARGET_FILE_SIZE) // 2
    return sum(1 for m in metas
               if m.file_size < small_bound) >= threshold


def compact_manifests(table, force: bool = False) -> Optional[int]:
    """Run one manifest full-compaction when the threshold trigger
    fires (or unconditionally with `force=True`).  Returns the new
    snapshot id, or None when nothing was done."""
    if not force and not manifest_compaction_needed(table):
        return None
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.metrics import (
        PLAN_MANIFEST_COMPACTIONS, global_registry,
    )
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    sid = commit.compact_manifests()
    if sid is not None:
        global_registry().plan_metrics().counter(
            PLAN_MANIFEST_COMPACTIONS).inc()
    return sid
