"""Row-level DELETE.

Counterpart of paimon_tpu/index/dv_maintainer.py; the deletion-vector
index files it writes are the reference's byte for byte.

reference semantics:
- append tables: deletion vectors keyed by row position
  (deletionvectors/BucketedDvMaintainer.java + append DV support;
  flink DeleteAction / spark DeleteFromTableCommand)
- primary-key tables: -D records through the normal merge path

The DV path evaluates the predicate per physical file (vectorized Arrow
compute), merges the matching positions into the bucket's existing
deletion vectors, writes ONE roaring-wire index file per bucket and
commits index-manifest entries (old bucket DV entries deleted, new one
added) — readers then mask those positions during scan.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.index.deletion_vector import (
    DeletionVector, DeletionVectorsIndexFile,
)
from paimon_tpu_torch.manifest import FileKind
from paimon_tpu_torch.manifest.index_manifest import (
    DELETION_VECTORS_INDEX, IndexFileMeta, IndexManifestEntry,
)
from paimon_tpu_torch.types import RowKind

__all__ = ["delete_where"]


def delete_where(table, predicate) -> Optional[int]:
    """Delete all rows matching `predicate`. Returns the snapshot id, or
    None when nothing matched."""
    if table.primary_keys:
        return _delete_pk(table, predicate)
    return _delete_append_dv(table, predicate)


def _delete_pk(table, predicate) -> Optional[int]:
    rows = table.to_arrow(predicate=predicate)
    if rows.num_rows == 0:
        return None
    wb = table.new_batch_write_builder()
    with wb.new_write(apply_defaults=False) as w:
        w.write_arrow(rows.select([f.name for f in table.schema.fields]),
                      row_kinds=np.full(rows.num_rows, RowKind.DELETE,
                                        np.int8))
        sid = wb.new_commit().commit(w.prepare_commit())
    return sid


def _delete_append_dv(table, predicate, max_retries: int = 5
                      ) -> Optional[int]:
    """Optimistic: DVs are computed against the latest snapshot and the
    commit asserts that snapshot is still latest — a concurrent commit
    forces a full replan so no concurrent deletes are lost."""
    from paimon_tpu_torch.core.commit import CommitConflictError

    for _ in range(max_retries):
        try:
            return _delete_append_dv_once(table, predicate)
        except CommitConflictError:
            continue
    raise CommitConflictError(
        f"delete_where lost the race {max_retries} times; retry later")


class BucketDvEdits:
    """The deletion vectors of every (partition, bucket) one plan edits,
    gathered across all of the bucket's splits, then written as ONE
    index file a bucket that replaces the bucket's previous ones.

    An append bucket bins into several splits, and each carries the
    whole bucket's vectors: a file written per split would hold the
    other splits' old vectors, and since readers merge a bucket's files
    in turn, the last would bring their deleted rows back.  Shared by
    predicate deletes, row-id deletes and evolution compaction."""

    def __init__(self, table, fs_scan, snapshot):
        self._scan = fs_scan
        self._prev: List[IndexManifestEntry] = []
        if snapshot.index_manifest:
            self._prev = [
                e for e in
                fs_scan.index_manifest_file.read(snapshot.index_manifest)
                if e.index_file.index_type == DELETION_VECTORS_INDEX]
        self._index = DeletionVectorsIndexFile(table.file_io,
                                               f"{table.path}/index")
        self._dvs: Dict[Tuple[bytes, int], Dict[str, DeletionVector]] = {}
        self._changed = set()

    def _key(self, split) -> Tuple[bytes, int]:
        return (self._scan._partition_codec.to_bytes(split.partition),
                split.bucket)

    def of(self, split) -> Dict[str, DeletionVector]:
        """The split's bucket's vectors, by data file, to edit in place
        (the same dict for every split of the bucket)."""
        key = self._key(split)
        dvs = self._dvs.get(key)
        if dvs is None:
            dvs = self._dvs[key] = dict(split.deletion_vectors or {})
        return dvs

    def changed(self, split) -> None:
        self._changed.add(self._key(split))

    def index_entries(self) -> List[IndexManifestEntry]:
        """Per changed bucket: the index-manifest DELETE of each previous
        file and the ADD of the merged one."""
        out: List[IndexManifestEntry] = []
        for pbytes, bucket in sorted(self._changed):
            dvs = self._dvs[(pbytes, bucket)]
            name, size, ranges = self._index.write(
                dvs, path_factory=self._scan.path_factory)
            total = sum(dv.cardinality() for dv in dvs.values())
            out.extend(IndexManifestEntry(FileKind.DELETE, e.partition,
                                          e.bucket, e.index_file)
                       for e in self._prev
                       if e.partition == pbytes and e.bucket == bucket)
            out.append(IndexManifestEntry(
                FileKind.ADD, pbytes, bucket,
                IndexFileMeta(DELETION_VECTORS_INDEX, name, size, total,
                              dv_ranges=ranges)))
        return out


def _delete_append_dv_once(table, predicate) -> Optional[int]:
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.kv_file import read_kv_file
    from paimon_tpu_torch.core.read import evolve_table
    from paimon_tpu_torch.options import CoreOptions

    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return None
    # value-stats pruning: files that cannot match keep their DVs as-is
    scan = table.new_scan().with_value_filter(predicate)
    plan = scan.plan(snapshot)

    edits = BucketDvEdits(table, scan, snapshot)
    schema_cache = {table.schema.id: table.schema}
    tracked = table.options.get(CoreOptions.ROW_TRACKING_ENABLED)
    for split in plan.splits:
        bucket_dvs = edits.of(split)
        if tracked:
            # row-tracked files form evolution groups whose CURRENT
            # values merge across overlays; evaluate the predicate on
            # the merged view and key the DV on the group's anchor
            # (the only file whose DV the evolution read applies)
            if _delete_tracked_groups(table, split, predicate,
                                      bucket_dvs):
                edits.changed(split)
            continue
        for meta in split.data_files:
            t = read_kv_file(table.file_io, scan.path_factory,
                             split.partition, split.bucket, meta,
                             options=table.options, device=table.device)
            t = evolve_table(t, meta.schema_id, table.schema,
                             table.schema_manager, schema_cache)
            mask = _eval_predicate(predicate, t)
            existing = bucket_dvs.get(meta.file_name)
            if existing is not None:
                mask[existing.positions[existing.positions
                                        < len(mask)]] = False
            positions = np.flatnonzero(mask)
            if len(positions) == 0:
                continue
            edits.changed(split)
            dv = DeletionVector(positions)
            bucket_dvs[meta.file_name] = existing.merge(dv) \
                if existing is not None else dv

    index_entries = edits.index_entries()
    if not index_entries:
        return None
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit.commit([], index_entries=index_entries,
                         expected_latest_id=snapshot.id)


def _delete_tracked_groups(table, split, predicate, bucket_dvs) -> bool:
    """Predicate delete over evolution groups: read each row-range
    group's merged current values, mask, and DV the anchor file."""
    from paimon_tpu_torch.core.append import AppendSplitRead
    from paimon_tpu_torch.core.row_tracking import (
        anchor_of, group_row_ranges, read_evolution_group,
    )

    read = AppendSplitRead(table.file_io, table.path, table.schema,
                           table.options,
                           schema_manager=table.schema_manager,
                           device=table.device)
    fields = sorted(set(predicate.fields()))
    changed = False
    for group in group_row_ranges(split.data_files):
        anchor = anchor_of(group)
        current = read_evolution_group(read, split, group, fields) \
            if anchor.first_row_id is not None or len(group) > 1 \
            else read.read_file(split, anchor)
        mask = _eval_predicate(predicate, current)
        existing = bucket_dvs.get(anchor.file_name)
        if existing is not None:
            mask[existing.positions[existing.positions < len(mask)]] = \
                False
        positions = np.flatnonzero(mask)
        if len(positions) == 0:
            continue
        changed = True
        dv = DeletionVector(positions)
        bucket_dvs[anchor.file_name] = existing.merge(dv) \
            if existing is not None else dv
    return changed


def _eval_predicate(predicate, t: pa.Table) -> np.ndarray:
    """Boolean row mask of `predicate` over `t` (null -> False)."""
    import pyarrow.dataset as ds

    expr = predicate.to_arrow()
    out = ds.dataset(t).scanner(columns={"m": expr}).to_table()
    return np.asarray(out.column("m").combine_chunks().cast(pa.bool_())
                      .fill_null(False))
