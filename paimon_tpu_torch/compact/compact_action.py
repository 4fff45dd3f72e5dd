"""Table-level compact action: pick + rewrite + commit per bucket.

Counterpart of paimon_tpu/compact/compact_action.py for primary-key
tables, with its tpu.mesh.compact route (append-table, row-tracked and
sort compactions are not ported yet).  reference: the dedicated
compaction job path (flink action/CompactAction -> StoreCompactOperator
-> MergeTreeCompactManager), engine-free here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.compact.manager import MergeTreeCompactManager
from paimon_tpu_torch.core.commit import FileStoreCommit
from paimon_tpu_torch.core.write import CommitMessage
from paimon_tpu_torch.options import ChangelogProducer, CoreOptions
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

__all__ = ["compact_table"]


def _group_entries(scan, snapshot):
    """{(partition_bytes, bucket): [files]} + total_buckets map."""
    groups: Dict[Tuple[bytes, int], list] = {}
    total_buckets: Dict[Tuple[bytes, int], int] = {}
    for e in scan.read_entries(snapshot):
        key = (e.partition, e.bucket)
        groups.setdefault(key, []).append(e.file)
        total_buckets[key] = e.total_buckets
    return groups, total_buckets


def compact_table(table, full: bool = False,
                  partition_filter: Optional[dict] = None
                  ) -> Optional[int]:
    """Compact every (partition, bucket) that has work on the table's
    device; commit one COMPACT snapshot.  Returns the snapshot id or
    None if there was nothing to do.

    With `tpu.mesh.compact`, full compactions route per merge engine:
    engines the mesh engine runs (parallel/mesh_engine.py) compact every
    bucket in one streamed mesh program; anything else (other engines,
    changelog producers, partition-filtered or non-full compactions)
    takes the single-chip manager below."""
    if (full and partition_filter is None
            and table.options.get(CoreOptions.MESH_COMPACT)):
        from paimon_tpu_torch.parallel.mesh_engine import (
            SUPPORTED_MERGE_ENGINES, compact_table_mesh,
        )
        if (table.options.merge_engine in SUPPORTED_MERGE_ENGINES
                and table.options.changelog_producer
                == ChangelogProducer.NONE):
            return compact_table_mesh(table).snapshot_id
    scan = table.new_scan()
    if partition_filter:
        scan.with_partition_filter(partition_filter)
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return None
    groups, total_buckets = _group_entries(scan, snapshot)

    messages: List[CommitMessage] = []
    for (pbytes, bucket), files in groups.items():
        partition = scan._partition_codec.from_bytes(pbytes)
        mgr = MergeTreeCompactManager(
            table.file_io, table.path, table.schema, table.options,
            partition, bucket, files,
            schema_manager=table.schema_manager, device=table.device)
        result = mgr.compact(full=full)
        if result is None or result.is_empty():
            continue
        messages.append(CommitMessage(
            partition=partition, bucket=bucket,
            total_buckets=total_buckets[(pbytes, bucket)],
            compact_before=result.before,
            compact_after=result.after,
            compact_changelog=result.changelog))

    if not messages:
        return None
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit.commit(messages, BATCH_COMMIT_IDENTIFIER)
