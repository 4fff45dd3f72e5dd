"""Row tracking + data evolution for append tables.

Counterpart of paimon_tpu/core/row_tracking.py: the same row ids, the
same overlay and deletion-vector files, on the host as in the reference.

reference:
- row-id assignment at commit: `FileStoreCommitImpl.assignRowTracking`
  (paimon-core/.../operation/FileStoreCommitImpl.java:1046) — every ADD
  file of an append snapshot gets `firstRowId`, the snapshot records
  `nextRowId`, and a file's rows own ids [firstRowId, firstRowId+rows).
- column-level updates: evolution files carry a SUBSET of columns
  (`DataFileMeta.writeCols`) for an existing row range; reads group
  files by row range and take each column from the newest file that
  wrote it, anchored on the oldest full file
  (operation/DataEvolutionSplitRead.java:190 mergeRangesAndSort +
  utils/DataEvolutionUtils.retrieveAnchorFile:41).
- row-id deletes: deletion vectors resolved by row id
  (append/dataevolution/DataEvolutionCompactDeletionVectorRewriter.java).

Shape: ranges are dense, so every mapping here is arithmetic
on numpy vectors — row id -> (file, position) is a searchsorted over
range starts, update application is one scatter per file, and the
evolution read assembles Arrow columns without touching row data of
unchanged columns.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.manifest import (
    DataFileMeta, FileKind, FileSource, ManifestEntry, SimpleStats,
)

ROW_ID_COL = "_ROW_ID"

__all__ = ["ROW_ID_COL", "assign_row_ids", "group_row_ranges",
           "read_evolution_group", "update_columns", "delete_by_row_ids"]


def assign_row_ids(entries: List[ManifestEntry], start: int
                   ) -> Tuple[List[ManifestEntry], int]:
    """Give every ADD entry without a first_row_id a dense id range
    starting at `start`; returns the rewritten entries and the next free
    row id (reference FileStoreCommitImpl.assignRowTracking)."""
    out = []
    nxt = start
    for e in entries:
        if e.kind == FileKind.ADD and e.file.first_row_id is None:
            out.append(ManifestEntry(
                e.kind, e.partition, e.bucket, e.total_buckets,
                replace(e.file, first_row_id=nxt)))
            nxt += e.file.row_count
        else:
            out.append(e)
    return out, nxt


def group_row_ranges(files: Sequence[DataFileMeta]
                     ) -> List[List[DataFileMeta]]:
    """Group files whose [first_row_id, first_row_id + rows) ranges
    overlap; groups come back sorted by range start (reference
    DataEvolutionSplitRead.mergeRangesAndSort).  Files without a row id
    each form their own group."""
    untracked = [f for f in files if f.first_row_id is None]
    tracked = sorted((f for f in files if f.first_row_id is not None),
                     key=lambda f: (f.first_row_id, f.max_sequence_number,
                                    f.file_name))
    groups: List[List[DataFileMeta]] = [[f] for f in untracked]
    cur: List[DataFileMeta] = []
    cur_end = -1
    for f in tracked:
        if cur and f.first_row_id < cur_end:
            cur.append(f)
            cur_end = max(cur_end, f.first_row_id + f.row_count)
        else:
            if cur:
                groups.append(cur)
            cur = [f]
            cur_end = f.first_row_id + f.row_count
    if cur:
        groups.append(cur)
    return groups


def anchor_of(group: Sequence[DataFileMeta]) -> DataFileMeta:
    """The oldest file of a range group — the full-row base every
    evolution file overlays (reference DataEvolutionUtils
    .retrieveAnchorFile: min by (maxSequenceNumber, fileName))."""
    return min(group, key=lambda f: (f.max_sequence_number, f.file_name))


def _column_source(group: Sequence[DataFileMeta], column: str,
                   schema_cols: Sequence[str]) -> Optional[DataFileMeta]:
    """Newest file in the group that wrote `column`."""
    best = None
    for f in group:
        cols = f.write_cols if f.write_cols is not None else schema_cols
        if column in cols:
            if best is None or (f.max_sequence_number, f.file_name) > \
                    (best.max_sequence_number, best.file_name):
                best = f
    return best


def read_evolution_group(read, split, group: Sequence[DataFileMeta],
                         wanted: Sequence[str]) -> pa.Table:
    """Assemble the current rows of one row-range group: each wanted
    column comes whole from its newest writer; `_ROW_ID` (when in
    `wanted`) derives from the anchor's first_row_id.  `read` is the
    AppendSplitRead (supplies file reading + schema evolution)."""
    anchor = anchor_of(group)
    schema_cols = [f.name for f in read.schema.fields]

    # plan column -> source file first, so every file is read once
    sources: Dict[str, DataFileMeta] = {}
    per_file: Dict[str, List[str]] = {}
    metas: Dict[str, DataFileMeta] = {}
    for c in wanted:
        if c == ROW_ID_COL:
            continue
        src = _column_source(group, c, schema_cols)
        if src is None:                   # column added after every file
            src = anchor
        sources[c] = src
        metas[src.file_name] = src
        per_file.setdefault(src.file_name, []).append(c)

    cache: Dict[str, pa.Table] = {
        fname: read.read_file(split, metas[fname], wanted=cols)
        for fname, cols in per_file.items()}

    cols, names = [], []
    for c in wanted:
        if c == ROW_ID_COL:
            continue
        t = cache[sources[c].file_name]
        if c in t.column_names:
            col = t.column(c)
        else:
            arrow_t = read.arrow_type_of(c)
            col = pa.nulls(anchor.row_count, arrow_t)
        names.append(c)
        cols.append(col)
    out = pa.table(dict(zip(names, cols))) if names else \
        pa.table({"__dummy": pa.nulls(anchor.row_count)}) \
        .drop_columns(["__dummy"])
    if ROW_ID_COL in wanted and anchor.first_row_id is not None:
        rid = pa.array(np.arange(anchor.first_row_id,
                                 anchor.first_row_id + anchor.row_count,
                                 dtype=np.int64), pa.int64())
        out = out.append_column(ROW_ID_COL, rid)
    return out


def _write_tracked_file(table, fs_scan, split, chunk, *, row_count,
                        first_row_id, min_seq, max_seq, level=0,
                        file_source=None, write_cols=None,
                        stats_cols=None):
    """Encode one row-tracked data file + its DataFileMeta (shared by
    update_columns overlays and evolution compaction)."""
    from paimon_tpu_torch.format import get_format
    from paimon_tpu_torch.format.format import extract_simple_stats
    from paimon_tpu_torch.core.kv_file import _safe_stats

    cols = stats_cols or [f.name for f in table.schema.fields]
    fmt = get_format(table.options.file_format)
    name = fs_scan.path_factory.new_data_file_name(fmt.extension)
    path, external = fs_scan.path_factory.new_data_file_location(
        split.partition, split.bucket, name)
    size = fmt.create_writer(table.options.file_compression,
                             table.options.format_options).write(
        table.file_io, path, chunk)
    mins, maxs, nulls = extract_simple_stats(chunk, cols)
    by_name = {f.name: f.type for f in table.schema.fields}
    types = [by_name[c] for c in cols]
    meta = DataFileMeta(
        file_name=name, file_size=size, row_count=row_count,
        min_key=b"", max_key=b"", key_stats=SimpleStats.EMPTY,
        value_stats=_safe_stats(types, mins, maxs, nulls),
        min_sequence_number=min_seq, max_sequence_number=max_seq,
        schema_id=table.schema.id, level=level,
        file_source=FileSource.APPEND if file_source is None
        else file_source,
        value_stats_cols=stats_cols,
        first_row_id=first_row_id, write_cols=write_cols,
        external_path=external)
    return meta, path


# -- update by row id --------------------------------------------------------

def update_columns(table, row_ids: np.ndarray, updates: pa.Table,
                   max_retries: int = 5) -> Optional[int]:
    """Column-level UPDATE: rewrite only the updated columns of the
    row-range groups that contain `row_ids`, as evolution files sharing
    the group's first_row_id with write_cols = updated columns
    (reference append/dataevolution write path).  Unchanged columns'
    bytes are never rewritten.

    Optimistic: the overlay bakes in the CURRENT values of untouched
    rows, so the commit asserts the planning snapshot is still latest
    and replans on conflict — otherwise two concurrent updates of one
    range would silently revert each other's rows."""
    from paimon_tpu_torch.core.commit import CommitConflictError

    for _ in range(max_retries):
        try:
            return _update_columns_once(table, row_ids, updates)
        except CommitConflictError:
            continue
    raise CommitConflictError(
        f"update_columns lost the race {max_retries} times")


def _update_columns_once(table, row_ids: np.ndarray,
                         updates: pa.Table) -> Optional[int]:
    from paimon_tpu_torch.core.commit import FileStoreCommit

    if len(row_ids) != updates.num_rows:
        raise ValueError("row_ids and updates must align")
    if table.primary_keys:
        raise ValueError("update_columns is for append tables "
                         "(row-tracking.enabled)")
    upd_cols = list(updates.column_names)
    for c in upd_cols:
        if c not in [f.name for f in table.schema.fields]:
            raise ValueError(f"unknown column {c!r}")

    order = np.argsort(row_ids, kind="stable")
    row_ids = np.asarray(row_ids, dtype=np.int64)[order]
    updates = updates.take(pa.array(order))

    snapshot = table.latest_snapshot()
    if snapshot is None:
        return None
    fs_scan = table.new_scan()
    plan = fs_scan.plan(snapshot)
    read = table.new_read_builder().new_read()._read
    max_seq = max((f.max_sequence_number for s in plan.splits
                   for f in s.data_files), default=-1) + 1

    # coverage first (pure range arithmetic, no IO): unknown row ids
    # must fail BEFORE any overlay file is written
    targets = []
    covered = np.zeros(len(row_ids), dtype=bool)
    for split in plan.splits:
        for group in group_row_ranges(split.data_files):
            anchor = anchor_of(group)
            if anchor.first_row_id is None:
                continue
            lo = anchor.first_row_id
            hi = lo + anchor.row_count
            a = np.searchsorted(row_ids, lo, side="left")
            b = np.searchsorted(row_ids, hi, side="left")
            if a == b:
                continue
            covered[a:b] = True
            targets.append((split, group, anchor, a, b))
    if not covered.all():
        missing = row_ids[~covered][:5].tolist()
        raise ValueError(f"row ids not found in any tracked range "
                         f"(e.g. {missing}); is row-tracking.enabled on?")

    new_msgs = []
    written_paths = []
    for split, group, anchor, a, b in targets:
        lo = anchor.first_row_id
        local = (row_ids[a:b] - lo).astype(np.int64)
        current = read_evolution_group(read, split, group, upd_cols)
        cols_out = {}
        for c in upd_cols:
            old = current.column(c).combine_chunks()
            new_vals = updates.column(c).slice(
                a, b - a).combine_chunks().cast(old.type)
            # vectorized scatter: concat old+new, take with an index
            # vector whose updated slots point into the new tail
            combined = pa.concat_arrays([old, new_vals])
            idx = np.arange(len(old), dtype=np.int64)
            idx[local] = len(old) + np.arange(len(new_vals),
                                              dtype=np.int64)
            cols_out[c] = combined.take(pa.array(idx))
        chunk = pa.table(cols_out)

        meta, path = _write_tracked_file(
            table, fs_scan, split, chunk, row_count=anchor.row_count,
            first_row_id=anchor.first_row_id, min_seq=max_seq,
            max_seq=max_seq, write_cols=upd_cols, stats_cols=upd_cols)
        written_paths.append(path)
        from paimon_tpu_torch.core.write import CommitMessage
        new_msgs.append(CommitMessage(
            split.partition, split.bucket, split.total_buckets,
            new_files=[meta]))
    if not new_msgs:
        return None
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    try:
        return commit.commit(new_msgs, expected_latest_id=snapshot.id)
    except BaseException:
        # the retry wrapper replans and rewrites: this attempt's overlay
        # files would otherwise linger until orphan cleanup
        for p in written_paths:
            table.file_io.delete_quietly(p)
        raise


def delete_by_row_ids(table, row_ids: Sequence[int],
                      max_retries: int = 5) -> Optional[int]:
    """Row-id DELETE on a tracked append table: ids resolve to (anchor
    file, position) by pure range arithmetic — no data reads — and merge
    into the deletion-vector index (reference row-id keyed DVs).
    Optimistic like predicate deletes: replans on commit conflicts."""
    from paimon_tpu_torch.core.commit import CommitConflictError

    for _ in range(max_retries):
        try:
            return _delete_by_row_ids_once(table, row_ids)
        except CommitConflictError:
            continue
    raise CommitConflictError(
        f"delete_by_row_ids lost the race {max_retries} times")


def _delete_by_row_ids_once(table, row_ids: Sequence[int]
                            ) -> Optional[int]:
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.index.deletion_vector import DeletionVector
    from paimon_tpu_torch.index.dv_maintainer import BucketDvEdits

    row_ids = np.unique(np.asarray(list(row_ids), dtype=np.int64))
    if len(row_ids) == 0:
        return None
    snapshot = table.latest_snapshot()
    if snapshot is None:
        return None
    fs_scan = table.new_scan()
    plan = fs_scan.plan(snapshot)

    edits = BucketDvEdits(table, fs_scan, snapshot)
    covered = np.zeros(len(row_ids), dtype=bool)
    for split in plan.splits:
        bucket_dvs = edits.of(split)
        for group in group_row_ranges(split.data_files):
            anchor = anchor_of(group)
            if anchor.first_row_id is None:
                continue
            lo = anchor.first_row_id
            a = np.searchsorted(row_ids, lo, side="left")
            b = np.searchsorted(row_ids, lo + anchor.row_count, "left")
            if a == b:
                continue
            covered[a:b] = True
            positions = (row_ids[a:b] - lo).astype(np.int64)
            existing = bucket_dvs.get(anchor.file_name)
            dv = DeletionVector(positions)
            bucket_dvs[anchor.file_name] = existing.merge(dv) \
                if existing is not None else dv
            edits.changed(split)
    if not covered.all():
        missing = row_ids[~covered][:5].tolist()
        raise ValueError(f"row ids not found (e.g. {missing})")
    index_entries = edits.index_entries()
    if not index_entries:
        return None
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit.commit([], index_entries=index_entries,
                         expected_latest_id=snapshot.id)


def compact_row_tracked(table, partition_filter=None,
                        max_retries: int = 5) -> Optional[int]:
    """Retry wrapper: a concurrent commit between plan and publish
    replans instead of surfacing, like the other tracked mutations."""
    from paimon_tpu_torch.core.commit import CommitConflictError

    for _ in range(max_retries):
        try:
            return _compact_row_tracked_once(table, partition_filter)
        except CommitConflictError:
            continue
    raise CommitConflictError(
        f"evolution compaction lost the race {max_retries} times")


def _compact_row_tracked_once(table, partition_filter=None
                              ) -> Optional[int]:
    """Data-evolution compaction: fold each row-range group's overlay
    files into ONE full file that keeps the group's firstRowId (row ids
    never move — reference append/dataevolution/
    DataEvolutionCompactTask.java / DataEvolutionNormalCompactTask).
    Deletion vectors stay row-position keyed: they re-key from the old
    anchor file to the rewritten file in the same commit.  Groups with
    a single file are already settled and stay untouched."""
    from paimon_tpu_torch.core.append import AppendSplitRead
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.write import CommitMessage
    from paimon_tpu_torch.index.dv_maintainer import BucketDvEdits

    snapshot = table.latest_snapshot()
    if snapshot is None:
        return None
    fs_scan = table.new_scan()
    if partition_filter:
        fs_scan.with_partition_filter(partition_filter)
    plan = fs_scan.plan(snapshot)
    read = AppendSplitRead(table.file_io, table.path, table.schema,
                           table.options,
                           schema_manager=table.schema_manager,
                           device=table.device)
    value_cols = [f.name for f in table.schema.fields]

    edits = BucketDvEdits(table, fs_scan, snapshot)
    messages = []
    written_paths = []
    for split in plan.splits:
        groups = [g for g in group_row_ranges(split.data_files)
                  if len(g) > 1]
        if not groups:
            continue
        bucket_dvs = edits.of(split)
        before: List[DataFileMeta] = []
        after: List[DataFileMeta] = []
        for group in groups:
            anchor = anchor_of(group)
            merged = read_evolution_group(read, split, group, value_cols)
            meta, path = _write_tracked_file(
                table, fs_scan, split, merged,
                row_count=anchor.row_count,
                first_row_id=anchor.first_row_id,
                min_seq=anchor.min_sequence_number,
                max_seq=max(f.max_sequence_number for f in group),
                level=max(f.level for f in group),
                file_source=FileSource.COMPACT)
            written_paths.append(path)
            before.extend(group)
            after.append(meta)
            dv = bucket_dvs.pop(anchor.file_name, None)
            if dv is not None:
                # positions are unchanged: the DV just follows the file
                bucket_dvs[meta.file_name] = dv
                edits.changed(split)
        if not before:
            continue
        messages.append(CommitMessage(
            split.partition, split.bucket, split.total_buckets,
            compact_before=before, compact_after=after))
    if not messages:
        return None
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    try:
        return commit.commit(messages,
                             index_entries=edits.index_entries(),
                             expected_latest_id=snapshot.id)
    except BaseException:
        for p in written_paths:
            table.file_io.delete_quietly(p)
        raise
