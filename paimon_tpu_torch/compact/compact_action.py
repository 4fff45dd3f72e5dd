"""Table-level compact action: pick + rewrite + commit per bucket.

Counterpart of paimon_tpu/compact/compact_action.py: primary-key tables
with the tpu.mesh.compact route and the postpone rescale; append tables
(small files concatenated in sequence order, deletion vectors applied
and their index entries rewritten; row-tracked tables fold their
overlays, core/row_tracking.py); and sort-compact, whose curve keys are
ranked and sorted on the table's device (ops/zorder.py).

reference: the dedicated compaction job path (flink
action/CompactAction -> StoreCompactOperator ->
MergeTreeCompactManager), engine-free here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.compact.manager import MergeTreeCompactManager
from paimon_tpu_torch.core.commit import FileStoreCommit
from paimon_tpu_torch.core.write import CommitMessage
from paimon_tpu_torch.options import ChangelogProducer, CoreOptions
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

__all__ = ["compact_table", "sort_compact", "rescale_postpone"]


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


def _make_append_writer(table, path_factory):
    from paimon_tpu_torch.core.append import AppendFileWriter
    return AppendFileWriter.from_options(table.file_io, path_factory,
                                         table.schema, table.options)


def _read_bucket(table, path_factory, partition, bucket, files,
                 dvs=None):
    """Read+evolve a bucket's files in sequence order, applying deletion
    vectors so rewrites never resurrect deleted rows."""
    import pyarrow as pa

    from paimon_tpu_torch.core.kv_file import read_kv_file
    from paimon_tpu_torch.core.read import evolve_table

    cache = {table.schema.id: table.schema}
    tables = []
    for f in sorted(files, key=lambda x: x.min_sequence_number):
        t = read_kv_file(table.file_io, path_factory, partition, bucket,
                         f, schema=table.schema,
                         schema_manager=table.schema_manager,
                         options=table.options, device=table.device)
        if dvs and f.file_name in dvs:
            t = t.filter(pa.array(dvs[f.file_name].keep_mask(t.num_rows)))
        tables.append(evolve_table(t, f.schema_id, table.schema,
                                   table.schema_manager, cache))
    return pa.concat_tables(tables, promote_options="none")


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
    if (full and table.schema.primary_keys and partition_filter is None
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

    is_append = not table.schema.primary_keys
    if is_append and table.options.get(CoreOptions.ROW_TRACKING_ENABLED):
        # row-tracked files own dense id ranges; a plain rewrite would
        # move positions and orphan overlays and row-id deletion
        # vectors, so each row-range group's overlays fold into one full
        # file that keeps the group's first row id (reference
        # append/dataevolution/DataEvolutionCompactTask)
        from paimon_tpu_torch.core.row_tracking import compact_row_tracked
        return compact_row_tracked(table,
                                   partition_filter=partition_filter)
    dv_index = scan._load_deletion_vectors(snapshot) \
        if is_append else {}
    messages: List[CommitMessage] = []
    for (pbytes, bucket), files in groups.items():
        partition = scan._partition_codec.from_bytes(pbytes)
        if is_append:
            result = _append_compact(
                table, scan, partition, bucket, files, full,
                bucket_dvs=dv_index.get((pbytes, bucket)),
                pbytes=pbytes, snapshot=snapshot)
        else:
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
            compact_changelog=result.changelog,
            index_entries=getattr(result, "index_entries", [])))

    if not messages:
        return None
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    index_list = [e for m in messages for e in m.index_entries]
    return commit.commit(messages, BATCH_COMMIT_IDENTIFIER,
                         index_entries=index_list or None)


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
                             -2, e.file, schema=table.schema,
                             schema_manager=table.schema_manager,
                             options=table.options, device=table.device)
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


def sort_compact(table, order_by, strategy: str = "zorder"):
    """Rewrite an append table clustered by `order_by` columns
    (reference flink sort-compact: ZorderSorter / OrderSorter over
    append tables), each bucket's curve keys ranked and sorted on the
    table's device; the rewrite commits as COMPACT."""
    import pyarrow as pa

    from paimon_tpu_torch.manifest import FileSource
    from paimon_tpu_torch.ops.zorder import (
        hilbert_permutation, order_permutation, z_order_permutation,
    )

    if not order_by:
        raise ValueError("sort-compact requires at least one order-by "
                         "column")
    names = {f.name for f in table.schema.fields}
    missing = [c for c in order_by if c not in names]
    if missing:
        raise ValueError(f"Unknown order-by columns {missing}")
    if table.schema.primary_keys:
        raise ValueError("sort-compact applies to append tables "
                         "(pk tables cluster by key already)")
    perm_fn = {"zorder": z_order_permutation,
               "hilbert": hilbert_permutation,
               "order": order_permutation}.get(strategy)
    if perm_fn is None:
        raise ValueError(f"Unknown sort strategy {strategy!r} "
                         f"(zorder | hilbert | order)")

    scan = table.new_scan()
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return None
    groups, total_buckets = _group_entries(scan, snapshot)
    dv_index = scan._load_deletion_vectors(snapshot)

    # DV rows are physically dropped by the rewrite; the bucket's DV
    # index entries must be deleted along with it
    index_entries = []
    if snapshot.index_manifest:
        from paimon_tpu_torch.manifest import FileKind
        from paimon_tpu_torch.manifest.index_manifest import (
            DELETION_VECTORS_INDEX, IndexManifestEntry,
        )
        for e in scan.index_manifest_file.read(snapshot.index_manifest):
            if e.index_file.index_type == DELETION_VECTORS_INDEX and \
                    (e.partition, e.bucket) in groups:
                index_entries.append(IndexManifestEntry(
                    FileKind.DELETE, e.partition, e.bucket, e.index_file))

    writer = _make_append_writer(table, scan.path_factory)
    messages: List[CommitMessage] = []
    for (pbytes, bucket), files in groups.items():
        partition = scan._partition_codec.from_bytes(pbytes)
        ordered = sorted(files, key=lambda f: f.min_sequence_number)
        data = _read_bucket(table, scan.path_factory, partition, bucket,
                            ordered, dvs=dv_index.get((pbytes, bucket)))
        perm = perm_fn(data, order_by, device=table.device)
        clustered = data.take(pa.array(perm))
        after = writer.write(partition, bucket, clustered,
                             ordered[0].min_sequence_number,
                             file_source=FileSource.COMPACT)
        messages.append(CommitMessage(
            partition=partition, bucket=bucket,
            total_buckets=total_buckets[(pbytes, bucket)],
            compact_before=ordered, compact_after=after))
    if not messages:
        return None
    if index_entries:
        messages[0].index_entries.extend(index_entries)
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    index_list = [e for m in messages for e in m.index_entries]
    return commit.commit(messages, BATCH_COMMIT_IDENTIFIER,
                         index_entries=index_list or None)


def _append_compact(table, scan, partition, bucket, files, full,
                    bucket_dvs=None, pbytes=None, snapshot=None):
    """Concatenate small append files into target-size files (reference
    append/BucketedAppendCompactManager: no keys, order by sequence).
    Deletion vectors of rewritten files are applied (rows physically
    dropped) and the bucket's DV index entries rewritten to cover only
    the surviving files."""
    from paimon_tpu_torch.core.append import (
        AppendCompactResult, append_compact_plan,
    )
    from paimon_tpu_torch.manifest import FileSource

    picked = append_compact_plan(files, table.options, full=full,
                                 dvs=bucket_dvs)
    if not picked:
        return None
    writer = _make_append_writer(table, scan.path_factory)
    data = _read_bucket(table, scan.path_factory, partition, bucket,
                        picked, dvs=bucket_dvs)
    after = writer.write(partition, bucket, data,
                         picked[0].min_sequence_number,
                         file_source=FileSource.COMPACT)
    result = AppendCompactResult(before=list(picked), after=after)

    picked_names = {f.file_name for f in picked}
    if bucket_dvs and picked_names & set(bucket_dvs):
        from paimon_tpu_torch.index.deletion_vector import (
            DeletionVectorsIndexFile,
        )
        from paimon_tpu_torch.manifest import FileKind
        from paimon_tpu_torch.manifest.index_manifest import (
            DELETION_VECTORS_INDEX, IndexFileMeta, IndexManifestEntry,
        )
        for e in scan.index_manifest_file.read(snapshot.index_manifest):
            if e.index_file.index_type == DELETION_VECTORS_INDEX and \
                    e.partition == pbytes and e.bucket == bucket:
                result.index_entries.append(IndexManifestEntry(
                    FileKind.DELETE, e.partition, e.bucket, e.index_file))
        remaining = {f: dv for f, dv in bucket_dvs.items()
                     if f not in picked_names}
        if remaining:
            dv_file = DeletionVectorsIndexFile(table.file_io,
                                               f"{table.path}/index")
            name, size, ranges = dv_file.write(
                remaining, path_factory=scan.path_factory)
            result.index_entries.append(IndexManifestEntry(
                FileKind.ADD, pbytes, bucket,
                IndexFileMeta(DELETION_VECTORS_INDEX, name, size,
                              sum(d.cardinality()
                                  for d in remaining.values()),
                              dv_ranges=ranges)))
    return result
