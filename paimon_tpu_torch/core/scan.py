"""Scan planning: snapshot -> manifests -> pruned ManifestEntries ->
DataSplits.

Counterpart of paimon_tpu/core/scan.py without the delta-apply plan
cache, the columnar stats sidecar, file indexes and deletion vectors
(not ported yet): every plan walks the snapshot's manifest lists.
Streaming reads plan one snapshot's delta (`plan_delta`) or changelog
(`plan_changelog`) files into splits that keep every row kind.

reference: operation/AbstractFileStoreScan.java (manifest pruning),
table/source/SnapshotReaderImpl.java:87 (generateSplits:412),
MergeTreeSplitGenerator.java:38, DataSplit.java:62.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from paimon_tpu_torch.data.binary_row import BinaryRowCodec
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import (
    DataFileMeta, FileKind, ManifestEntry, ManifestFile, ManifestList,
    merge_manifest_entries,
)
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.predicate import Predicate
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.snapshot import Snapshot, SnapshotManager
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["DataSplit", "ScanPlan", "FileStoreScan"]


@dataclass
class DataSplit:
    """reference table/source/DataSplit.java:62."""
    snapshot_id: int
    partition: Tuple
    bucket: int
    total_buckets: int
    data_files: List[DataFileMeta]
    raw_convertible: bool = False
    # streaming split: reads emit a _ROW_KIND column
    for_streaming: bool = False
    # delta/changelog split: true row kinds preserved (-U/-D survive);
    # full-phase streaming splits emit merged state as all +I instead
    is_delta: bool = False

    @property
    def row_count(self) -> int:
        return sum(f.row_count for f in self.data_files)


@dataclass
class ScanPlan:
    snapshot_id: Optional[int]
    splits: List[DataSplit]
    # plan produced by a streaming scan (reads stay schema-stable with a
    # _ROW_KIND column even when splits is empty)
    streaming: bool = False

    @property
    def row_count(self) -> int:
        return sum(s.row_count for s in self.splits)


class FileStoreScan:
    def __init__(self, file_io: FileIO, table_path: str,
                 schema: TableSchema, options: CoreOptions,
                 branch: str = "main"):
        self.file_io = file_io
        self.table_path = table_path
        self.schema = schema
        self.options = options
        self.snapshot_manager = SnapshotManager(file_io, table_path, branch)
        self.path_factory = FileStorePathFactory.from_options(
            table_path, schema.partition_keys, options)
        self.branch = branch
        rt = schema.logical_row_type()
        self.partition_types = [rt.get_field(k).type
                                for k in schema.partition_keys]
        self.key_types = [rt.get_field(k).type
                          for k in schema.trimmed_primary_keys()]
        self._partition_codec = BinaryRowCodec(self.partition_types)
        compression = options.get(CoreOptions.MANIFEST_COMPRESSION)
        codec = {"zstd": "zstandard", "none": "null"}.get(compression,
                                                          compression)
        mdir = self.path_factory.manifest_dir
        self.manifest_file = ManifestFile(file_io, mdir, codec,
                                          self.partition_types,
                                          key_types=self.key_types)
        self.manifest_list = ManifestList(file_io, mdir, codec)
        self._partition_filter: Optional[dict] = None
        self._bucket_filter: Optional[set] = None
        self._key_filter: Optional[Predicate] = None
        self._value_filter: Optional[Predicate] = None

    # -- fluent filters ------------------------------------------------------

    def with_partition_filter(self, spec: dict) -> "FileStoreScan":
        self._partition_filter = spec
        return self

    def with_buckets(self, buckets: Sequence[int]) -> "FileStoreScan":
        self._bucket_filter = set(buckets)
        return self

    def with_key_filter(self, predicate: Predicate) -> "FileStoreScan":
        self._key_filter = predicate
        return self

    def with_value_filter(self, predicate: Predicate) -> "FileStoreScan":
        self._value_filter = predicate
        return self

    # -- planning ------------------------------------------------------------

    def plan(self, snapshot: Optional[Snapshot] = None,
             streaming: bool = False) -> ScanPlan:
        if snapshot is None:
            snapshot = self.snapshot_manager.latest_snapshot()
        if snapshot is None:
            return ScanPlan(None, [], streaming=streaming)
        return ScanPlan(snapshot.id,
                        self.generate_splits(snapshot.id,
                                             self.read_entries(snapshot),
                                             for_streaming=streaming),
                        streaming=streaming)

    def plan_delta(self, snapshot: Snapshot,
                   streaming: bool = False) -> ScanPlan:
        """Only this snapshot's delta files (for incremental/streaming
        reads, reference DeltaFollowUpScanner). With streaming=True the
        splits preserve row kinds for changelog consumers."""
        return self._plan_added(snapshot, snapshot.delta_manifest_list,
                                streaming)

    def plan_changelog(self, snapshot: Snapshot,
                       streaming: bool = False) -> ScanPlan:
        """Only this snapshot's changelog files (reference
        ChangelogFollowUpScanner); an empty plan when it carries none."""
        if not snapshot.changelog_manifest_list:
            return ScanPlan(snapshot.id, [], streaming=streaming)
        return self._plan_added(snapshot, snapshot.changelog_manifest_list,
                                streaming)

    def _plan_added(self, snapshot: Snapshot, manifest_list: str,
                    streaming: bool) -> ScanPlan:
        metas = self.manifest_list.read(manifest_list)
        adds = [e for e in self._read_manifests(metas)
                if e.kind == FileKind.ADD]
        return ScanPlan(snapshot.id,
                        self.generate_splits(snapshot.id, adds,
                                             for_delta=True,
                                             for_streaming=streaming),
                        streaming=streaming)

    def read_entries(self, snapshot: Snapshot) -> List[ManifestEntry]:
        """Live (merged, ADD-only) entry set at one snapshot, after
        manifest-level partition pruning."""
        if snapshot.index_manifest:
            raise NotImplementedError(
                "snapshot carries an index manifest (deletion vectors or "
                "dynamic-bucket index); not ported yet (ROADMAP.md: the "
                "remaining planes)")
        metas = self.manifest_list.read_all(snapshot.base_manifest_list,
                                            snapshot.delta_manifest_list)
        entries = self._read_manifests(self._prune_manifests(metas))
        return merge_manifest_entries(entries)

    # -- manifest IO ---------------------------------------------------------

    def _read_manifests(self, metas) -> List[ManifestEntry]:
        # scan.manifest.parallelism (reference
        # AbstractFileStoreScan#parallelism); order is preserved by
        # mapping in meta order
        par = self.options.get(CoreOptions.SCAN_MANIFEST_PARALLELISM)
        if par and par > 1 and len(metas) > 1:
            from paimon_tpu_torch.parallel.executors import new_thread_pool
            pool = new_thread_pool(par, "paimon-scan-manifest")
            try:
                per = list(pool.map(
                    lambda m: self.manifest_file.read(m.file_name),
                    metas))
            finally:
                pool.shutdown(wait=True)
            return [e for chunk in per for e in chunk]
        entries = []
        for m in metas:
            entries.extend(self.manifest_file.read(m.file_name))
        return entries

    def _prune_manifests(self, metas):
        """Skip whole manifests whose partition stats exclude the
        partition filter (reference AbstractFileStoreScan
        manifest-level pruning)."""
        if not self._partition_filter or not self.partition_types:
            return metas
        return [m for m in metas if self._manifest_may_match(m)]

    def _manifest_may_match(self, m) -> bool:
        """The partition filter against one manifest's decoded
        partition stats (min <= value <= max)."""
        stats = m.partition_stats
        if not stats.null_counts and stats.min_values == b"":
            return True
        try:
            mins, maxs = stats.decode(self.partition_types)
        except Exception:
            return True
        for i, k in enumerate(self.schema.partition_keys):
            if k in self._partition_filter:
                v = self._partition_filter[k]
                if mins[i] is not None and maxs[i] is not None and \
                        not (str(mins[i]) <= str(v) <= str(maxs[i])):
                    return False
        return True

    def _partition_matches(self, pbytes: bytes) -> bool:
        """The partition filter against one entry's partition."""
        if not self._partition_filter:
            return True
        values = self._partition_codec.from_bytes(pbytes)
        for i, k in enumerate(self.schema.partition_keys):
            if k in self._partition_filter and \
                    str(values[i]) != str(self._partition_filter[k]):
                return False
        return True

    def _entry_visible(self, e: ManifestEntry) -> bool:
        """Per-file visibility. NOTE: value-predicate pruning for
        primary-key tables is NOT applied here — a file without matching
        values may still hold the newest version of a key whose older
        version matches, so dropping it would corrupt the merge; value
        pruning for pk tables happens at bucket granularity in
        generate_splits (reference applies value filters per
        non-overlapping section for the same reason)."""
        if self._bucket_filter is not None and \
                e.bucket not in self._bucket_filter:
            return False
        if not self._partition_matches(e.partition):
            return False
        if self._key_filter is not None and self.schema.primary_keys:
            key_types = [t.copy(False) for t in (
                self.schema.logical_row_type().get_field(k).type
                for k in self.schema.trimmed_primary_keys())]
            try:
                mins, maxs = e.file.key_stats.decode(key_types)
            except Exception:
                return True
            names = self.schema.trimmed_primary_keys()
            if not self._key_filter.test_stats(
                    dict(zip(names, mins)), dict(zip(names, maxs)),
                    dict(zip(names, e.file.key_stats.null_counts
                             or [0] * len(names))),
                    e.file.row_count):
                return False
        return True

    def _value_stats_match(self, e: ManifestEntry) -> bool:
        value_types = [f.type.as_nullable() for f in self.schema.fields]
        names = [f.name for f in self.schema.fields]
        try:
            mins, maxs = e.file.value_stats.decode(value_types)
        except Exception:
            return True
        return self._value_filter.test_stats(
            dict(zip(names, mins)), dict(zip(names, maxs)),
            dict(zip(names, e.file.value_stats.null_counts
                     or [0] * len(names))),
            e.file.row_count)

    def _bucket_value_match(self, group: List[ManifestEntry]) -> bool:
        """Whole-bucket value pruning for pk tables: skip the bucket only
        when NO file could match (merge-safe — if any file might match,
        every file must be read so newer versions participate)."""
        if self._value_filter is None or not self.schema.primary_keys:
            return True
        return any(self._value_stats_match(e) for e in group)

    def generate_splits(self, snapshot_id: int,
                        entries: List[ManifestEntry],
                        for_delta: bool = False,
                        for_streaming: bool = False) -> List[DataSplit]:
        groups: Dict[Tuple, List[ManifestEntry]] = {}
        for e in entries:
            if not self._entry_visible(e):
                continue
            groups.setdefault((e.partition, e.bucket), []).append(e)
        splits = []
        for key, group in sorted(
                groups.items(), key=lambda kv: (kv[0][0], kv[0][1])):
            splits.extend(self._group_splits(snapshot_id, key, group,
                                             for_delta, for_streaming))
        return splits

    def _group_splits(self, snapshot_id: int, key: Tuple[bytes, int],
                      group: List[ManifestEntry], for_delta: bool,
                      for_streaming: bool) -> List[DataSplit]:
        """The split of ONE (partition, bucket) group of visible entries:
        pk buckets stay whole for the merge; a delta or changelog split
        reads its files raw."""
        if not group or not self._bucket_value_match(group):
            return []
        pbytes, bucket = key
        files = [g.file for g in group]
        max_level = max(f.level for f in files)
        # raw-convertible only when a single non-L0 run fully covers
        # the bucket
        raw = for_delta or (
            all(f.level == max_level and max_level > 0 for f in files)
            and all((f.delete_row_count or 0) == 0 for f in files))
        return [DataSplit(
            snapshot_id=snapshot_id,
            partition=self._partition_codec.from_bytes(pbytes),
            bucket=bucket,
            total_buckets=group[0].total_buckets,
            data_files=files,
            raw_convertible=raw,
            for_streaming=for_streaming,
            is_delta=for_delta,
        )]

    # -- helpers for writers -------------------------------------------------

    def max_sequence_number(self, partition: Tuple, bucket: int) -> int:
        snapshot = self.snapshot_manager.latest_snapshot()
        if snapshot is None:
            return -1
        pbytes = self._partition_codec.to_bytes(partition)
        best = -1
        for e in self.read_entries(snapshot):
            if e.partition == pbytes and e.bucket == bucket:
                best = max(best, e.file.max_sequence_number)
        return best
