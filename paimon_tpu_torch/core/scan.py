"""Scan planning: snapshot -> manifests -> pruned ManifestEntries ->
DataSplits.

Counterpart of paimon_tpu/core/scan.py.  A split carries the deletion
vectors of its bucket (index/deletion_vector.py), loaded from the
snapshot's index manifest.  Per-file column indexes
(index/file_index.py) skip files: a key predicate drops a file whose
indexes prove no row can match; on a primary-key table a value
predicate drops a bucket only when no file of it can match, since a
file without a match may hold the newest version of a key whose older
version matches, while an append table drops single files by their
value stats and indexes.  An append bucket bins into splits of about
`source.split.target-size`, each file costing at least
`source.split.open-file-cost`.
Streaming reads plan one snapshot's delta (`plan_delta`) or changelog
(`plan_changelog`) files into splits that keep every row kind.  The
index manifest (`index_manifest_file`) holds the dynamic-bucket hash
index and the deletion vectors.  Postpone staging (bucket -2) stays
invisible unless the bucket filter names it.

The incremental metadata plane:

* **Delta-apply plan reuse**: `plan()` consults the process-shared plan
  cache (core/plan_cache.py).  With a cached live-entry state at
  snapshot N, a plan for N+k reads only the delta manifest lists of
  snapshots N+1..N+k and folds their ADD/DELETE entries into the cached
  groups; OVERWRITE commits, expired snapshots, unknown DELETEs and
  recreated snapshot ids invalidate back to the cold walk.  Generated
  splits are reused per filter signature, regenerating only the
  (partition, bucket) groups the deltas touched.
* **Vectorised manifest pruning**: `_prune_manifests` evaluates the
  partition, bucket and key-range predicates against whole manifest
  lists at once through the columnar stats sidecar
  (manifest/stats_sidecar.py), so pruned manifests are never fetched
  and none of their entries are decoded.  A list without a readable
  sidecar degrades to the per-meta Python check, counted as the plan
  group's `sidecar_fallbacks`.

reference: operation/AbstractFileStoreScan.java (manifest pruning),
table/source/SnapshotReaderImpl.java:87 (generateSplits:412),
MergeTreeSplitGenerator.java:38, DataSplit.java:62.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace as dc_replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from paimon_tpu_torch.data.binary_row import BinaryRowCodec
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import (
    DataFileMeta, FileKind, IndexManifestFile, ManifestEntry, ManifestFile,
    ManifestList, merge_manifest_entries,
)
from paimon_tpu_torch.manifest.index_manifest import DELETION_VECTORS_INDEX
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.predicate import Predicate
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.snapshot import CommitKind, Snapshot, SnapshotManager
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
    deletion_vectors: Optional[Dict[str, Any]] = None   # file -> DV

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
        sidecar = bool(options.get(CoreOptions.MANIFEST_STATS_SIDECAR))
        self.manifest_file = ManifestFile(file_io, mdir, codec,
                                          self.partition_types,
                                          key_types=self.key_types,
                                          sidecar=sidecar)
        self.manifest_list = ManifestList(
            file_io, mdir, codec, partition_types=self.partition_types,
            key_types=self.key_types, sidecar=sidecar)
        self.index_manifest_file = IndexManifestFile(file_io, mdir, codec)
        # the plan metric group, allocated up front so every series
        # renders (manifest_compactions' producer is
        # maintenance/manifest_compact.py); the port's own
        # sidecar_fallbacks counter is allocated at its first count
        from paimon_tpu_torch import metrics as m
        pm = m.global_registry().plan_metrics()
        self._m_plans = pm.counter(m.PLAN_PLANS)
        self._m_plan_ms = pm.histogram(m.PLAN_MS)
        self._m_delta_applies = pm.counter(m.PLAN_DELTA_APPLIES)
        self._m_manifests_read = pm.counter(m.PLAN_MANIFESTS_READ)
        self._m_manifests_pruned = pm.counter(m.PLAN_MANIFESTS_PRUNED)
        self._m_entries_decoded = pm.counter(m.PLAN_ENTRIES_DECODED)
        pm.counter(m.PLAN_MANIFEST_COMPACTIONS)
        self._partition_filter: Optional[dict] = None
        self._bucket_filter: Optional[set] = None
        self._key_filter: Optional[Predicate] = None
        self._value_filter: Optional[Predicate] = None
        # per data file: its indexes, keyed by the meta's identity (a
        # rewrite_file_index commit replaces a meta under the same file
        # name), for this scan object's lifetime
        self._file_index_cache: Dict[tuple, object] = {}
        self._arrow_types: Optional[Dict[str, object]] = None

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
        t0 = time.perf_counter()
        if snapshot is None:
            snapshot = self.snapshot_manager.latest_snapshot()
        if snapshot is None:
            return ScanPlan(None, [], streaming=streaming)
        plan = ScanPlan(snapshot.id, self._plan_splits(snapshot, streaming),
                        streaming=streaming)
        from paimon_tpu_torch.metrics import global_registry
        from paimon_tpu_torch.obs.trace import (
            STAGE_PLAN_LINK, span, tracing_enabled,
        )
        if tracing_enabled():
            ctx = (snapshot.properties or {}).get("trace.context")
            if ctx:
                # the snapshot's committer stamped its trace context:
                # link this plan to it
                with span(STAGE_PLAN_LINK, cat="scan", link=ctx,
                          snapshot=snapshot.id):
                    pass
        dt_ms = (time.perf_counter() - t0) * 1000
        self._m_plans.inc()
        self._m_plan_ms.update(dt_ms)
        g = global_registry().scan_metrics()
        g.histogram("plan_ms").update(dt_ms)
        g.counter("plans").inc()
        return plan

    def _plan_splits(self, snapshot: Snapshot,
                     streaming: bool) -> List[DataSplit]:
        """The split set of one snapshot, through the plan cache when a
        state can be served or advanced, else the pruned cold walk."""
        cache, served = self._cached_state(snapshot)
        if served is not None:
            state, touched, base_id = served
            return self._splits_from_state(cache, state, snapshot,
                                           streaming, touched=touched,
                                           split_base_id=base_id)
        if cache is not None and self._cold_state_allowed(cache, snapshot):
            # unfiltered cold walk: the full live-entry set is exactly
            # the cache state; build it once, then generate from it
            state, live = self._cold_state(snapshot)
            if state is not None:
                cache.put_state(state, None)
                return self._splits_from_state(
                    cache, state, snapshot, streaming,
                    touched=None, split_base_id=None)
            # over scan.plan.cache.max-entries: generate from the walk
            # already decoded, and remember the verdict so later plans
            # of this tip go straight to the pruned walk
            cache.mark_over_bound(snapshot.id)
            return self.generate_splits(snapshot, live,
                                        for_streaming=streaming)
        # filtered (or cache-disabled, or over-bound) cold walk: the
        # vectorised manifest prune keeps whole manifests unfetched
        return self.generate_splits(
            snapshot, self.read_entries(snapshot, _use_cache=False),
            for_streaming=streaming)

    def _cached_state(self, snapshot: Snapshot):
        """(cache, served) for one snapshot: `cache` is the table's
        TablePlanCache, or None when disabled or when `snapshot` is a
        genuine time travel behind the cached tip; `served` is
        (state, touched groups, split base snapshot id) when the cached
        state serves `snapshot` as is or delta-applied, else None (a
        dead state has been dropped)."""
        cache = self._plan_cache()
        if cache is None:
            return None, None
        state = cache.state()
        if state is None:
            return cache, None
        if state.snapshot_id == snapshot.id:
            if state.matches_tip(snapshot):
                return cache, (state, frozenset(), snapshot.id)
            # recreated snapshot id (rollback_to / fast_forward): the
            # cached state describes different content
            cache.drop_state(state)
        elif state.snapshot_id < snapshot.id:
            adv = self._advance_state(state, snapshot)
            if adv is not None:
                new_state, touched = adv
                cache.put_state(new_state, state)
                self._m_delta_applies.inc()
                return cache, (new_state, touched, state.snapshot_id)
            cache.drop_state(state)
        elif self._state_anchor_alive(state):
            # genuine time travel to an older snapshot: serve it from a
            # cold walk without disturbing the cached tip
            return None, None
        else:
            # rolled-back tip: the anchor snapshot is gone, so drop the
            # dead state and rebuild at this snapshot
            cache.drop_state(state)
        return cache, None

    def _cold_state_allowed(self, cache, snapshot: Snapshot) -> bool:
        """An unfiltered plan may build the cache state by a full walk;
        a filtered one (prunable key bounds included) takes the pruned
        walk, where the sidecar can skip whole manifests."""
        return (self._partition_filter is None
                and self._bucket_filter is None
                and self._key_prune_bounds() is None
                and not cache.over_bound(snapshot.id))

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
                        self.generate_splits(snapshot, adds,
                                             for_delta=True,
                                             for_streaming=streaming),
                        streaming=streaming)

    def read_entries(self, snapshot: Snapshot,
                     _use_cache: bool = True) -> List[ManifestEntry]:
        """Live (merged, ADD-only) entry set at one snapshot, served
        from (and feeding) the plan cache when it can.  It may be a
        superset of a filtered scan's visible entries: manifest pruning
        is conservative, and callers apply their own per-entry
        filters."""
        if _use_cache:
            cache, served = self._cached_state(snapshot)
            if served is not None:
                return [e for d in served[0].groups.values()
                        for e in d.values()]
            if cache is not None and \
                    self._cold_state_allowed(cache, snapshot):
                state, live = self._cold_state(snapshot)
                if state is not None:
                    cache.put_state(state, None)
                else:
                    cache.mark_over_bound(snapshot.id)
                return live
        metas = self.manifest_list.read_all(snapshot.base_manifest_list,
                                            snapshot.delta_manifest_list)
        metas = self._prune_manifests(metas, snapshot)
        entries = merge_manifest_entries(self._read_manifests(metas))
        return [e for e in entries if e.kind == FileKind.ADD]

    # -- delta-apply plan cache ----------------------------------------------

    def _plan_cache(self):
        """The process-shared TablePlanCache, or None when disabled."""
        if not self.options.get(CoreOptions.SCAN_PLAN_CACHE):
            return None
        from paimon_tpu_torch.core.plan_cache import shared_plan_cache
        return shared_plan_cache(self.table_path, self.branch)

    def _state_anchor_alive(self, state) -> bool:
        """True when the cached state's anchor snapshot still exists
        with the same content: genuine time travel (the cached tip
        stays) rather than a rolled-back tip (the state is dead)."""
        try:
            anchor = self.snapshot_manager.snapshot(state.snapshot_id)
        except (OSError, ValueError):
            return False
        return anchor is not None and state.matches_tip(anchor)

    @staticmethod
    def _fold_entry(groups, copied, touched, e) -> bool:
        """Apply one delta entry to the copy-on-write group map.  False
        for a DELETE whose file is not live (the delta was computed
        against a state this cache does not hold: invalidate)."""
        g = (e.partition, e.bucket)
        d = groups.get(g)
        if g not in copied:
            d = dict(d) if d is not None else {}
            groups[g] = d
            copied.add(g)
        touched.add(g)
        ident = e.identifier()
        if e.kind == FileKind.ADD:
            d[ident] = e
            return True
        if ident in d:
            del d[ident]
            return True
        return False

    def _cold_state(self, snapshot: Snapshot):
        """Full unpruned walk building the cacheable live-entry state
        (no scan filters: the state serves any filter, applied per
        entry at split generation).  Returns (state, live entries);
        state is None over scan.plan.cache.max-entries, but the live
        set is always returned so the caller never walks twice."""
        from paimon_tpu_torch.core.plan_cache import PlanState
        metas = self.manifest_list.read_all(snapshot.base_manifest_list,
                                            snapshot.delta_manifest_list)
        groups: Dict[Tuple[bytes, int], Dict[tuple, ManifestEntry]] = {}
        copied: set = set()
        for e in self._read_manifests(metas):
            self._fold_entry(groups, copied, set(), e)
        groups = {g: d for g, d in groups.items() if d}
        count = sum(len(d) for d in groups.values())
        live = [e for d in groups.values() for e in d.values()]
        if count > self.options.get(CoreOptions.SCAN_PLAN_CACHE_MAX_ENTRIES):
            return None, live
        return PlanState(snapshot.id, snapshot.base_manifest_list,
                         snapshot.delta_manifest_list,
                         snapshot.index_manifest, groups, count), live

    def _advance_state(self, state, snapshot: Snapshot):
        """Advance a cached state to `snapshot` by folding only the
        delta manifest lists of the snapshots in between.  Returns
        (new_state, frozenset(touched group keys)), or None to
        invalidate: an OVERWRITE commit, an expired or recreated
        snapshot along the walk, a DELETE of a file not held, or
        outgrowing the entry bound."""
        from paimon_tpu_torch.core.plan_cache import PlanState
        try:
            prev = self.snapshot_manager.snapshot(state.snapshot_id)
        except (OSError, ValueError):
            return None
        if prev is None or not state.matches_tip(prev):
            # the anchor id was recreated with different content: the
            # chain above it is not this state's
            return None
        groups = dict(state.groups)          # copy-on-write outer map
        copied: set = set()
        touched: set = set()
        for sid in range(state.snapshot_id + 1, snapshot.id + 1):
            if sid == snapshot.id:
                snap = snapshot
            else:
                try:
                    snap = self.snapshot_manager.snapshot(sid)
                except (OSError, ValueError):
                    return None
                if snap is None:
                    return None
            if snap.commit_kind == CommitKind.OVERWRITE:
                return None
            try:
                entries = self._read_manifests(
                    self.manifest_list.read(snap.delta_manifest_list))
            except (OSError, ValueError):
                # a list or manifest expired or repaired under the walk
                return None
            for e in entries:
                if not self._fold_entry(groups, copied, touched, e):
                    return None
        for g in list(touched):
            if not groups.get(g):
                groups.pop(g, None)
        count = sum(len(d) for d in groups.values())
        if count > self.options.get(CoreOptions.SCAN_PLAN_CACHE_MAX_ENTRIES):
            return None
        return (PlanState(snapshot.id, snapshot.base_manifest_list,
                          snapshot.delta_manifest_list,
                          snapshot.index_manifest, groups, count),
                frozenset(touched))

    def _split_signature(self, streaming: bool):
        """Hashable identity of the filters split generation depends
        on, or None when key or value predicates (not comparable across
        scan objects) make split states unreusable."""
        if self._key_filter is not None or self._value_filter is not None:
            return None
        pf = None
        if self._partition_filter:
            pf = frozenset((k, str(v))
                           for k, v in self._partition_filter.items())
        bf = frozenset(self._bucket_filter) \
            if self._bucket_filter is not None else None
        # the binning options matter too: the cache is shared per
        # (table, branch) across table objects whose dynamic options may
        # differ (table.copy)
        return (streaming, pf, bf,
                self.options.get(CoreOptions.SOURCE_SPLIT_TARGET_SIZE),
                self.options.get(CoreOptions.SOURCE_SPLIT_OPEN_FILE_COST))

    def _dv_from_state(self, cache, snapshot: Snapshot):
        """The unfiltered deletion-vector index, memoised per index
        manifest name (splits look up their own (partition, bucket), so
        extra groups are inert)."""
        key = snapshot.index_manifest
        hit, dv = cache.dv_memo(key)
        if hit:
            return dv
        dv = self._load_deletion_vectors(snapshot, unfiltered=True)
        cache.put_dv_memo(key, dv)
        return dv

    def _splits_from_state(self, cache, state, snapshot: Snapshot,
                           streaming: bool, touched, split_base_id):
        """This scan's splits from a cached live-entry state, with no
        manifest IO.  With a reusable filter signature and a split state
        generated at `split_base_id`, only `touched` groups re-run split
        generation (None: all)."""
        from paimon_tpu_torch.core.plan_cache import SplitState
        sig = self._split_signature(streaming)
        base = None
        if sig is not None and touched is not None:
            st = cache.split_state(sig)
            if st is not None and \
                    st.index_manifest == snapshot.index_manifest:
                if st.snapshot_id == snapshot.id:
                    base, regen = st.group_splits, frozenset()
                elif split_base_id is not None and \
                        st.snapshot_id == split_base_id:
                    base, regen = st.group_splits, touched
        group_splits: Dict[Tuple[bytes, int], tuple] = {}
        dv_index = self._dv_from_state(cache, snapshot)
        for g in state.groups:
            if base is not None and g not in regen and g in base:
                old = base[g]
                if old and old[0].snapshot_id != snapshot.id:
                    old = tuple(dc_replace(s, snapshot_id=snapshot.id)
                                for s in old)
                group_splits[g] = old
                continue
            visible = [e for e in state.groups[g].values()
                       if self._entry_visible(e)]
            group_splits[g] = tuple(self._group_splits(
                snapshot.id, g, visible, dv_index, for_delta=False,
                for_streaming=streaming))
        if sig is not None:
            cache.put_split_state(sig, SplitState(
                snapshot.id, snapshot.index_manifest, group_splits))
        out: List[DataSplit] = []
        for g in sorted(group_splits):
            out.extend(group_splits[g])
        return out

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
            entries = [e for chunk in per for e in chunk]
        else:
            entries = []
            for m in metas:
                entries.extend(self.manifest_file.read(m.file_name))
        self._m_manifests_read.inc(len(metas))
        self._m_entries_decoded.inc(len(entries))
        return entries

    def _key_prune_bounds(self):
        """(lo, hi) bounds the key filter puts on the first trimmed
        primary key (the sidecar's k_min/k_max columns), or None."""
        if self._key_filter is None or not self.schema.primary_keys:
            return None
        from paimon_tpu_torch.predicate import conjunctive_bounds
        names = self.schema.trimmed_primary_keys()
        if not names:
            return None
        b = conjunctive_bounds(self._key_filter, names[0])
        if b is None or (b[0] is None and b[1] is None):
            return None
        return b

    def _prune_manifests(self, metas, snapshot: Optional[Snapshot] = None):
        """Skip whole manifests before any fetch (reference
        AbstractFileStoreScan manifest-level pruning).  With a stats
        sidecar beside the snapshot's manifest lists the partition,
        bucket and key-range predicates evaluate vectorised over each
        whole list; metas no sidecar covers fall back to the per-meta
        Python partition check (counted in sidecar_fallbacks)."""
        key_bounds = self._key_prune_bounds()
        if (not self._partition_filter or not self.partition_types) \
                and self._bucket_filter is None and key_bounds is None:
            return metas
        sidecar_on = snapshot is not None and \
            self.options.get(CoreOptions.MANIFEST_STATS_SIDECAR)
        masks: Dict[str, bool] = {}
        if sidecar_on:
            from paimon_tpu_torch.manifest.stats_sidecar import (
                prune_keep_mask,
            )
            for list_name in (snapshot.base_manifest_list,
                              snapshot.delta_manifest_list):
                if not list_name:
                    continue
                stats = self.manifest_list.read_sidecar(list_name)
                if stats is None:
                    continue
                keep = prune_keep_mask(
                    stats, self.schema.partition_keys,
                    self._partition_filter, self._bucket_filter,
                    key_bounds)
                masks.update(zip(stats["file_name"].to_pylist(),
                                 keep.tolist()))
        out = []
        pruned = fallbacks = 0
        for m in metas:
            k = masks.get(m.file_name)
            if k is None:
                fallbacks += 1
                k = self._python_prune_keep(m)
            if k:
                out.append(m)
            else:
                pruned += 1
        self._m_manifests_pruned.inc(pruned)
        if sidecar_on and fallbacks:
            # the port's own counter, allocated at its first fallback so
            # a table's metric set stays the reference's until then
            from paimon_tpu_torch import metrics as m
            m.global_registry().plan_metrics().counter(
                m.PLAN_SIDECAR_FALLBACKS).inc(fallbacks)
        return out

    def _python_prune_keep(self, m) -> bool:
        """The per-meta check for manifests without sidecar stats:
        partition equality against the decoded partition stats."""
        if not self._partition_filter or not self.partition_types:
            return True
        stats = m.partition_stats
        if not stats.null_counts and stats.min_values == b"":
            return True
        try:
            mins, maxs = stats.decode(self.partition_types)
        except Exception:                   # noqa: BLE001 — advisory
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

    def _arrow_type_map(self) -> Dict[str, object]:
        if self._arrow_types is None:
            from paimon_tpu_torch.types import data_type_to_arrow
            out = {}
            for f in self.schema.fields:
                try:
                    out[f.name] = data_type_to_arrow(f.type)
                except (ValueError, NotImplementedError):
                    pass
            self._arrow_types = out
        return self._arrow_types

    def _file_indexes(self, e: ManifestEntry, pred):
        """A file's column indexes: its embedded blob, else the `.index`
        sidecar named in extra_files, whose entries are read for the
        columns `pred` names when a predicate first names them (a
        missing sidecar reads as no index)."""
        from paimon_tpu_torch.index.file_index import (
            read_indexes_blob, read_indexes_file,
        )
        f = e.file
        key = (e.partition, e.bucket, f.file_name, f.embedded_index,
               tuple(f.extra_files))
        cached = self._file_index_cache.get(key)
        if cached is None:
            fi, sidecar = read_indexes_blob(f.embedded_index), None
            if not fi:
                sidecar = next((x for x in f.extra_files
                                if x.endswith(".index")), None)
                if sidecar is not None:
                    sidecar = self.path_factory.data_file_path(
                        self._partition_codec.from_bytes(e.partition),
                        e.bucket, sidecar)
            cached = self._file_index_cache[key] = (fi, sidecar, set())
        fi, sidecar, asked = cached
        if sidecar is not None:
            new = {c for c in pred.fields()
                   if c not in asked and not fi.has(c)}
            if new:
                try:
                    fi.merge(read_indexes_file(self.file_io, sidecar, new))
                except FileNotFoundError:
                    pass
                asked |= new
        return fi

    def _bloom_rejects(self, e: ManifestEntry, pred) -> bool:
        """True when the file's indexes (bloom equality misses, bitmap,
        BSI and range-bitmap emptiness) prove no row matches `pred`
        (reference io/FileIndexEvaluator + FileIndexPredicate)."""
        if pred is None:
            return False
        fi = self._file_indexes(e, pred)
        if not fi:
            return False
        from paimon_tpu_torch.index.file_index import evaluate_skip
        return evaluate_skip(fi, pred, self._arrow_type_map())

    def _entry_visible(self, e: ManifestEntry) -> bool:
        """Per-file visibility. NOTE: value-predicate pruning for
        primary-key tables is NOT applied here — a file without matching
        values may still hold the newest version of a key whose older
        version matches, so dropping it would corrupt the merge; value
        pruning for pk tables happens at bucket granularity in
        generate_splits (reference applies value filters per
        non-overlapping section for the same reason)."""
        if e.bucket == -2 and (self._bucket_filter is None
                               or -2 not in self._bucket_filter):
            # postpone staging data is invisible until rescaled
            return False
        if self._bucket_filter is not None and \
                e.bucket not in self._bucket_filter:
            return False
        if not self._partition_matches(e.partition):
            return False
        if self._bloom_rejects(e, self._key_filter):
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
        if self._value_filter is not None and not self.schema.primary_keys:
            if self.options.get(CoreOptions.ROW_TRACKING_ENABLED):
                # row-tracked append files form row-range groups whose
                # columns merge across files (overlays): a per-file stats
                # prune could drop the anchor while its overlay survives,
                # so tracked tables prune only at read time
                return True
            # an append file holds no other version of its rows: it may
            # drop on its own value stats and indexes
            if not self._value_stats_match(e):
                return False
            if self._bloom_rejects(e, self._value_filter):
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
        return any(self._value_stats_match(e)
                   and not self._bloom_rejects(e, self._value_filter)
                   for e in group)

    def generate_splits(self, snapshot: Snapshot,
                        entries: List[ManifestEntry],
                        for_delta: bool = False,
                        for_streaming: bool = False
                        ) -> List[DataSplit]:
        groups: Dict[Tuple, List[ManifestEntry]] = {}
        for e in entries:
            if not self._entry_visible(e):
                continue
            groups.setdefault((e.partition, e.bucket), []).append(e)
        # deletion vectors always load once written (DELETE FROM); no IO
        # without an index manifest, pruned by the partition and bucket
        # filters
        dv_index = self._load_deletion_vectors(snapshot)
        splits = []
        for key, group in sorted(
                groups.items(), key=lambda kv: (kv[0][0], kv[0][1])):
            splits.extend(self._group_splits(snapshot.id, key, group,
                                             dv_index, for_delta,
                                             for_streaming))
        return splits

    def _group_splits(self, snapshot_id: int, key: Tuple[bytes, int],
                      group: List[ManifestEntry], dv_index,
                      for_delta: bool, for_streaming: bool
                      ) -> List[DataSplit]:
        """The splits of ONE (partition, bucket) group of visible entries
        (the unit the split-level plan cache regenerates): pk buckets
        stay whole for the merge; append buckets bin by size."""
        if not group or not self._bucket_value_match(group):
            return []
        pbytes, bucket = key
        files = [g.file for g in group]
        max_level = max(f.level for f in files)
        # append tables never merge; pk buckets are raw-convertible only
        # when a single non-L0 run without deletion vectors covers them
        raw = (not self.schema.primary_keys) or for_delta or (
            all(f.level == max_level and max_level > 0 for f in files)
            and all((f.delete_row_count or 0) == 0 for f in files)
            and (pbytes, bucket) not in dv_index)
        # an append bucket bins into size-bounded splits for parallel
        # readers (reference source.split.target-size / open-file-cost);
        # pk buckets stay whole for the merge.  A row-tracked range group
        # (an anchor file and its column overlays) bins whole, at its
        # first file's place: the reference bins file by file, and a
        # split that holds an overlay without its anchor reads the
        # overlay's rows a second time, with nulls in the columns it did
        # not write (ROADMAP.md C)
        file_bins = [files]
        if not self.schema.primary_keys and len(files) > 1:
            from paimon_tpu_torch.core.row_tracking import group_row_ranges
            target = self.options.get(CoreOptions.SOURCE_SPLIT_TARGET_SIZE)
            open_cost = self.options.get(
                CoreOptions.SOURCE_SPLIT_OPEN_FILE_COST)
            place = {id(f): i for i, f in enumerate(files)}
            units = sorted(group_row_ranges(files),
                           key=lambda g: min(place[id(f)] for f in g))
            file_bins = []
            cur, cur_size = [], 0
            for unit in units:
                sz = sum(max(f.file_size, open_cost) for f in unit)
                if cur and cur_size + sz > target:
                    file_bins.append(cur)
                    cur, cur_size = [], 0
                cur.extend(unit)
                cur_size += sz
            if cur:
                file_bins.append(cur)
        partition = self._partition_codec.from_bytes(pbytes)
        return [DataSplit(
            snapshot_id=snapshot_id,
            partition=partition,
            bucket=bucket,
            total_buckets=group[0].total_buckets,
            data_files=bin_files,
            raw_convertible=raw,
            for_streaming=for_streaming,
            is_delta=for_delta,
            deletion_vectors=dv_index.get((pbytes, bucket)),
        ) for bin_files in file_bins]

    def _load_deletion_vectors(self, snapshot: Snapshot,
                               unfiltered: bool = False):
        """{(partition bytes, bucket): {data file: DeletionVector}} of
        one snapshot; `unfiltered` ignores the scan's partition and
        bucket filters (the plan cache's memo serves any scan)."""
        if not snapshot.index_manifest:
            return {}
        from paimon_tpu_torch.index.deletion_vector import (
            read_deletion_vectors,
        )
        out: Dict[Tuple, Dict[str, Any]] = {}
        for e in self.index_manifest_file.read(snapshot.index_manifest):
            if e.index_file.index_type != DELETION_VECTORS_INDEX:
                continue
            if not unfiltered:
                if self._bucket_filter is not None and \
                        e.bucket not in self._bucket_filter:
                    continue
                if not self._partition_matches(e.partition):
                    continue
            dvs = read_deletion_vectors(
                self.file_io,
                self.path_factory.index_file_path(e.index_file.file_name),
                e.index_file.dv_ranges or {})
            out.setdefault((e.partition, e.bucket), {}).update(dvs)
        return out

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
