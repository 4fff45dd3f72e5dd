"""Table-level compact action: pick + rewrite + commit per bucket.

Counterpart of paimon_tpu/compact/compact_action.py for primary-key
tables, with its tpu.mesh.compact route and the postpone rescale
(append-table, row-tracked and sort compactions are not ported yet).  reference: the dedicated
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

__all__ = ["compact_table", "rescale_postpone"]


def _group_entries(scan, snapshot):
    """{(partition_bytes, bucket): [files]} + total_buckets map."""
    groups: Dict[Tuple[bytes, int], list] = {}
    total_buckets: Dict[Tuple[bytes, int], int] = {}
    for e in scan.read_entries(snapshot):
        if e.bucket == -2:
            # postpone staging compacts only through rescale_postpone
            # (a normal rewrite would drop its DELETE tombstones)
            continue
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


def rescale_postpone(table) -> Optional[int]:
    """Redistribute bucket-postpone staging data into real (dynamic)
    buckets (reference postpone/PostponeBucketFileStoreWrite + the
    rescale job). Returns the snapshot id or None when nothing staged."""
    scan = table.new_scan().with_buckets([-2])
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return None
    entries = [e for e in scan.read_entries(snapshot) if e.bucket == -2]
    if not entries:
        return None

    # route rows through a dynamic-bucket writer. Sizing precedence
    # (reference postpone.default-bucket-num /
    # postpone.target-row-num-per-bucket): explicit postpone.* knobs
    # win; an explicitly-set dynamic-bucket.* is respected next; else
    # the postpone defaults (5M rows/bucket, 4 initial) apply
    overrides = {"bucket": "-1"}
    raw = table.options.options
    if raw.contains(CoreOptions.POSTPONE_TARGET_ROW_NUM_PER_BUCKET) or \
            not raw.contains(CoreOptions.DYNAMIC_BUCKET_TARGET_ROW_NUM):
        overrides["dynamic-bucket.target-row-num"] = str(
            table.options.get(CoreOptions.POSTPONE_TARGET_ROW_NUM_PER_BUCKET))
    if raw.contains(CoreOptions.POSTPONE_DEFAULT_BUCKET_NUM) or \
            not raw.contains(CoreOptions.DYNAMIC_BUCKET_INITIAL_BUCKETS):
        overrides["dynamic-bucket.initial-buckets"] = str(
            table.options.get(CoreOptions.POSTPONE_DEFAULT_BUCKET_NUM))
    write_table = table.copy(overrides)
    wb = write_table.new_batch_write_builder()
    writer = wb.new_write(apply_defaults=False)
    try:
        return _rescale_with_writer(table, scan, writer, entries)
    finally:
        writer.close()


def _rescale_with_writer(table, scan, writer, entries):
    """The rescale body, writer-lifetime-managed by rescale_postpone's
    try/finally: a prepare_commit() raise (pipelined flush barrier)
    must still join the writer's pool."""
    import numpy as np
    import pyarrow as pa

    from paimon_tpu_torch.core.kv_file import read_kv_file
    from paimon_tpu_torch.core.read import evolve_table
    from paimon_tpu_torch.ops.merge import KIND_COL, SEQ_COL

    cache = {table.schema.id: table.schema}
    value_cols = [f.name for f in table.schema.fields]
    by_part: Dict[bytes, list] = {}
    for e in entries:
        by_part.setdefault(e.partition, []).append(e)
    messages: List[CommitMessage] = []
    for pbytes, es in by_part.items():
        partition = scan._partition_codec.from_bytes(pbytes)
        es.sort(key=lambda e: e.file.min_sequence_number)
        tables = []
        for e in es:
            t = read_kv_file(table.file_io, scan.path_factory, partition,
                             -2, e.file, options=table.options,
                             device=table.device)
            tables.append(evolve_table(t, e.file.schema_id, table.schema,
                                       table.schema_manager, cache,
                                       keep_sys_cols=True))
        staged = pa.concat_tables(tables, promote_options="none")
        order = np.argsort(np.asarray(staged.column(SEQ_COL)
                                      .combine_chunks().cast(pa.int64())),
                           kind="stable")
        staged = staged.take(pa.array(order))
        kinds = np.asarray(staged.column(KIND_COL).combine_chunks()
                           .cast(pa.int8()))
        writer.write_arrow(staged.select(value_cols), kinds)
        messages.append(CommitMessage(
            partition=partition, bucket=-2,
            total_buckets=es[0].total_buckets,
            compact_before=[e.file for e in es]))
    # rewritten files commit as compact_after so staging deletion and
    # publication land in ONE atomic COMPACT snapshot (a crash between
    # two snapshots would replay staged rows on the next rescale)
    for m in writer.prepare_commit():
        m.compact_after = m.new_files
        m.new_files = []
        messages.append(m)
    index_entries = [e for m in messages for e in m.index_entries]
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit.commit(messages, BATCH_COMMIT_IDENTIFIER,
                         index_entries=index_entries or None)
