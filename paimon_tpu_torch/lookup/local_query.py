"""LocalTableQuery: embedded point lookups over the LSM, backed by a
persistent, size-bounded local SST store.

Counterpart of paimon_tpu/lookup/local_query.py.  reference:
table/query/LocalTableQuery.java:69 (lookup:226) over
mergetree/LookupLevels.java:137, which turns remote files into local
sorted SSTs with bloom filters (lookup/sort/
SortLookupStoreFactory.java:39) and evicts them by disk size
(LookupLevels.java:308).

* The table is planned once per snapshot and its splits indexed by
  (partition, bucket); a snapshot-refresh TTL (`refresh_interval_ms`)
  gates how often the snapshot hint is read at all.
* Deduplicate tables (no sequence field, no record-level expire) take
  the LSM fast path: each data file spills lazily into its own
  immutable SST (lookup/sst.py, host work with the native probe), and a
  point get walks the bucket's sorted runs newest first, pruning files
  by manifest key ranges and bloom filters before any IO.
* Every other configuration (aggregation, partial-update, first-row,
  `sequence.field`) takes the merged fallback: the bucket's full
  merge-on-read (`MergeFileSplitRead.read_split`, on the table's
  device, so the winner-select kernel runs on the card) spilled as one
  SST keyed by the bucket's file list.
* Concurrent builds of one SST run once; plan refreshes build aside
  and publish by reference swap; readers of files dropped by
  compaction are evicted with their shared byte-cache entries.
"""

from __future__ import annotations

import hashlib
import json
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.bucket import FixedBucketAssigner
from paimon_tpu_torch.core.read import MergeFileSplitRead, assemble_runs
from paimon_tpu_torch.data.binary_row import BinaryRowCodec
from paimon_tpu_torch.lookup.sst import (
    BlockCache, LookupStore, SstReader, _key_hashes, pack_lanes,
)
from paimon_tpu_torch.ops.merge import KIND_COL, SEQ_COL
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.options import CoreOptions, MergeEngine
from paimon_tpu_torch.parallel.fault import is_transient_error
from paimon_tpu_torch.types import RowKind, data_type_to_arrow
from paimon_tpu_torch.utils.deadline import check_deadline

__all__ = ["LocalTableQuery"]

_UNLOADED = object()          # sentinel: no plan loaded yet


class LocalTableQuery:
    def __init__(self, table, cache_dir: Optional[str] = None,
                 max_memory_bytes: Optional[int] = None,
                 refresh_interval_ms: int = 0, clock=None,
                 delta=None):
        if not table.primary_keys:
            raise ValueError("LocalTableQuery requires a primary-key table")
        self.table = table
        # hot delta tier (service/delta.py): unflushed serving-writer
        # rows probed BEFORE the LSM walk — a delta hit (or tombstone)
        # short-circuits, a miss falls through.  Registered as a
        # reader: sealed generations retire only once OUR plan covers
        # them too
        self._delta = delta
        if delta is not None:
            delta.register_reader(self)
        self.options = table.options
        self.pk = table.schema.trimmed_primary_keys()
        rt = table.schema.logical_row_type()
        self.encoder = NormalizedKeyEncoder(
            [data_type_to_arrow(rt.get_field(k).type) for k in self.pk],
            nullable=[rt.get_field(k).type.nullable for k in self.pk])
        self.key_types = [rt.get_field(k).type for k in self.pk]
        self._key_codec = BinaryRowCodec(
            [t.copy(False) for t in self.key_types])
        bucket_keys = table.schema.bucket_keys()
        self.assigner = FixedBucketAssigner(
            bucket_keys, [rt.get_field(k).type for k in bucket_keys],
            max(1, table.options.bucket))
        if max_memory_bytes is None:
            max_memory_bytes = table.options.get(
                CoreOptions.LOOKUP_CACHE_MAX_MEMORY_SIZE)
        self.block_cache = BlockCache(max_memory_bytes)
        self.store = LookupStore(
            cache_dir or tempfile.mkdtemp(prefix="paimon-lookup-"),
            max_disk_bytes=table.options.get(
                CoreOptions.LOOKUP_CACHE_MAX_DISK_SIZE),
            block_cache=self.block_cache,
            native_probe=bool(table.options.get(
                CoreOptions.SERVICE_PROBE_NATIVE)))
        # snapshot-refresh TTL: within it, lookups never touch the
        # snapshot hint or manifest chain (service.lookup.refresh-
        # interval on the serving plane; 0 = check every call)
        self.refresh_interval_ms = max(0, int(refresh_interval_ms))
        self._clock = clock or (lambda: time.monotonic() * 1000.0)
        # _lock guards the PLAN (snapshot check/reload) and the
        # splits/file-ranges swap — never the data-file reads, SST
        # builds or probes, which run concurrently (LookupStore and
        # BlockCache are internally locked; _building dedupes
        # same-key builds): a cold bucket build must not stall every
        # other serving thread
        self._lock = threading.RLock()
        # serializes plan REFRESHES only (double-buffer): the new plan
        # builds aside under this lock and publishes under _lock by
        # reference swap; a lookup that finds a refresh in flight
        # serves the current plan instead of waiting
        self._refresh_lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._building: Dict[str, threading.Event] = {}
        self._snapshot_id = _UNLOADED
        self._last_check_ms: Optional[float] = None
        # (partition_key, bucket) -> DataSplit of the current plan
        self._splits: Dict[Tuple[str, int], object] = {}
        # file_name -> decoded (min_key_tuple, max_key_tuple) or None
        self._file_ranges: Dict[str, Optional[Tuple]] = {}
        # store keys of the current plan (None before the first load)
        self._live_keys: Optional[set] = None
        # shared split reader on the table's device: schema evolution
        # and the merged fallback (a full merge-on-read of the bucket,
        # the winner-select kernel on the card) ride the normal read path
        self._read = MergeFileSplitRead(
            table.file_io, table.path, table.schema, table.options,
            table.schema_manager, device=table.device)
        from paimon_tpu_torch.metrics import (
            LOOKUP_DELTA_HITS, LOOKUP_FILES_PRUNED,
            LOOKUP_READER_BUILDS, LOOKUP_READER_REUSES,
            LOOKUP_SNAPSHOT_REFRESHES, global_registry,
        )
        g = global_registry().lookup_metrics()
        self._m_refreshes = g.counter(LOOKUP_SNAPSHOT_REFRESHES)
        self._m_builds = g.counter(LOOKUP_READER_BUILDS)
        self._m_reuses = g.counter(LOOKUP_READER_REUSES)
        self._m_pruned = g.counter(LOOKUP_FILES_PRUNED)
        self._m_delta_hits = g.counter(LOOKUP_DELTA_HITS)

    # -- lifecycle -----------------------------------------------------------

    def refresh(self):
        """Force the next lookup to re-check the latest snapshot (the
        TTL is bypassed once).  Spilled per-file SSTs are keyed by
        immutable file names, so state for files still referenced
        survives — only vanished files are evicted."""
        with self._lock:
            self._last_check_ms = None

    def close(self):
        """Drop all spilled SSTs and cached blocks (the query service
        calls this on stop so stopped servers leak no disk).  The
        store is marked closed FIRST: an in-flight batch racing close
        gets an error from its rebuild instead of republishing SST
        files into the just-cleaned directory."""
        with self._lock:
            if self._delta is not None:
                self._delta.unregister_reader(self)
            self.store.drop_all(close=True)
            self._splits = {}
            self._file_ranges = {}
            self._snapshot_id = _UNLOADED
            self._last_check_ms = None

    def __enter__(self) -> "LocalTableQuery":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def snapshot_id(self) -> Optional[int]:
        """Snapshot the current plan serves (None before any load /
        on an empty table)."""
        sid = self._snapshot_id
        return None if sid is _UNLOADED else sid

    # -- snapshot tracking ---------------------------------------------------

    def _check_snapshot(self):
        """TTL-gated snapshot check; returns the (splits, snapshot_id)
        pair a batch should resolve against.  Callers capture the
        RETURNED references: `self._splits` is replaced (never
        mutated) on refresh, so a captured dict stays internally
        consistent for the whole batch even while a concurrent
        refresh swaps in a new plan.

        Double-buffered: the refresh builds
        the new plan ASIDE and publishes it by reference swap under
        `_lock`, and a lookup arriving while another thread holds the
        refresh serves the CURRENT plan instead of blocking on the
        manifest walk.  Only the very first load (no plan yet) waits.
        The TTL stamps only AFTER a successful check: a transient FS
        failure keeps surfacing on refresh attempts until it heals —
        though concurrent lookups ride the last good plan."""
        with self._lock:
            now = self._clock()
            due = (self._last_check_ms is None or
                   self.refresh_interval_ms <= 0 or
                   now - self._last_check_ms >= self.refresh_interval_ms)
            loaded = self._snapshot_id is not _UNLOADED
        if due:
            if self._refresh_lock.acquire(blocking=not loaded):
                try:
                    latest = \
                        self.table.snapshot_manager.latest_snapshot_id()
                    with self._lock:
                        stale = (self._snapshot_id is _UNLOADED or
                                 latest != self._snapshot_id)
                    if stale:
                        self._load_plan()
                    with self._lock:
                        self._last_check_ms = self._clock()
                finally:
                    self._refresh_lock.release()
            # else: a concurrent refresh is in flight — serve the
            # published plan, never block the lookup on it
        with self._lock:
            return self._splits, self._snapshot_id

    def _data_path(self, split, meta) -> str:
        if meta.external_path:
            return meta.external_path
        return self._read.path_factory.data_file_path(
            split.partition, split.bucket, meta.file_name)

    def _load_plan(self):
        """Re-plan the table and reconcile cached state: keep readers
        whose backing files are still referenced, evict the rest, and
        invalidate shared byte-cache entries for data files dropped by
        compaction/expiry.

        Runs WITHOUT holding `_lock` (caller serializes refreshes via
        `_refresh_lock`): the whole plan — a manifest walk riding the
        delta-apply plan cache — and the keep-set math happen aside,
        then the new plan publishes by one reference swap, so
        concurrent lookups never block on a refresh.  Keys are
        computed against the NEW snapshot: snapshot-keyed bucket
        readers (DV / record-expire) must be keyed by it, or last
        cycle's state survives one refresh too long."""
        plan = self.table.new_read_builder().new_scan().plan()
        new_splits: Dict[Tuple[str, int], object] = {}
        for s in plan.splits:
            new_splits[(self._pkey(s.partition), s.bucket)] = s
        live_keys = set()
        live_files = set()
        live_paths = set()
        for (pkey, b), s in new_splits.items():
            live_keys.add(self._bucket_store_key(pkey, s,
                                                 plan.snapshot_id))
            for f in s.data_files:
                live_keys.add(self._file_store_key(pkey, b, f))
                live_files.add(f.file_name)
                live_paths.add(self._data_path(s, f))
        with self._lock:
            old_splits = self._splits
            self._snapshot_id = plan.snapshot_id
            self._splits = new_splits
            self._live_keys = live_keys
            self._file_ranges = {k: v
                                 for k, v in self._file_ranges.items()
                                 if k in live_files}
        old_paths = {self._data_path(s, f)
                     for s in old_splits.values()
                     for f in s.data_files}
        for key in self.store.keys():
            if key not in live_keys:
                self.store.drop(key)
        from paimon_tpu_torch.fs.caching import evict_dropped_file
        for path in old_paths - live_paths:
            evict_dropped_file(path)
        if self._delta is not None:
            # our plan now covers everything at/below this snapshot:
            # sealed delta generations retire once EVERY reader says so
            self._delta.reader_advanced(self, plan.snapshot_id)
        self._m_refreshes.inc()

    # -- keys ----------------------------------------------------------------

    def _norm_partition(self, partition: Tuple) -> Tuple:
        """Normalize partition values through the partition fields'
        arrow types, so a caller's python scalars key identically to
        the plan's decoded values."""
        pkeys = self.table.partition_keys
        if not partition or not pkeys:
            return tuple(partition)
        rt = self.table.schema.logical_row_type()
        vals = []
        for v, k in zip(partition, pkeys):
            try:
                t = data_type_to_arrow(rt.get_field(k).type)
                vals.append(pa.array([v], t)[0].as_py())
            except (pa.ArrowInvalid, pa.ArrowTypeError, KeyError):
                vals.append(v)
        return tuple(vals)

    @staticmethod
    def _pkey(partition: Tuple) -> str:
        # unambiguous composite key: joining values with a separator
        # would collide for e.g. ('a_b','c') vs ('a','b_c')
        return json.dumps([repr(v) for v in tuple(partition)])

    def _file_store_key(self, pkey: str, bucket: int, meta) -> str:
        return f"file|{pkey}|{bucket}|{meta.file_name}"

    def _bucket_store_key(self, pkey: str, split, snap) -> str:
        """Merged-bucket state keyed by the bucket's FILE LIST, so a
        commit that leaves a bucket untouched leaves its reader warm.
        Record-level-expire configurations additionally key by
        snapshot (their merged view can change without the file list
        changing) — `snap` is the snapshot captured WITH the split, so
        a concurrent refresh cannot pair an old file list with the new
        snapshot id.  (The port refuses deletion vectors, which the
        reference keys by snapshot too.)"""
        names = ",".join(sorted(f.file_name for f in split.data_files))
        if self.options.record_level_expire_time_ms:
            names += f"|snap={'unloaded' if snap is _UNLOADED else snap}"
        digest = hashlib.sha1(names.encode()).hexdigest()[:20]
        return f"bucket|{pkey}|{split.bucket}|{digest}"

    # -- pruning -------------------------------------------------------------

    def _file_range(self, meta) -> Optional[Tuple]:
        """Decoded (min_key, max_key) value tuples from manifest stats
        — the before-any-IO prune; None = undecodable, never prune."""
        name = meta.file_name
        if name in self._file_ranges:
            return self._file_ranges[name]
        rng = None
        try:
            if meta.min_key and meta.max_key:
                rng = (tuple(self._key_codec.from_bytes(meta.min_key)),
                       tuple(self._key_codec.from_bytes(meta.max_key)))
        except Exception:       # noqa: BLE001 — stats are advisory
            rng = None
        self._file_ranges[name] = rng
        return rng

    @staticmethod
    def _in_range(key_tuple: Tuple, rng: Optional[Tuple]) -> bool:
        if rng is None:
            return True
        try:
            return rng[0] <= key_tuple <= rng[1]
        except TypeError:
            return True          # incomparable types: never prune

    # -- fast-path eligibility ----------------------------------------------

    def _fast_path_ok(self, split) -> bool:
        """Newest-run-wins short-circuiting is exactly deduplicate
        semantics; user sequence fields (row order != seq order) and
        record-level expire (time-dependent visibility) need the merged
        read path (deletion vectors are refused by the port)."""
        return (self.options.merge_engine == MergeEngine.DEDUPLICATE
                and not self.options.sequence_field
                and not self.options.record_level_expire_time_ms)

    # -- readers -------------------------------------------------------------

    def _encode_lanes(self, t: pa.Table) -> np.ndarray:
        lanes, _ = self.encoder.encode_table(t, self.pk)
        return lanes

    def _spill(self, key: str, t: pa.Table) -> SstReader:
        lanes = self._encode_lanes(t)
        order = np.argsort(pack_lanes(lanes), kind="stable")
        self._m_builds.inc()
        return self.store.put(key, lanes[order],
                              t.take(pa.array(order)))

    def _get_or_build(self, key: str, load) -> Optional[SstReader]:
        """store.get or build-ONCE: concurrent requests for the same
        key wait on the in-flight builder instead of duplicating the
        data-file read; the expensive load/sort/spill runs without
        any plan lock held."""
        while True:
            r = self.store.get(key)
            if r is not None:
                self._m_reuses.inc()
                return r
            with self._build_lock:
                ev = self._building.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._building[key] = ev
                    break                # we are the builder
            # bounded wait on the in-flight builder: a request whose
            # deadline is spent stops waiting (the builder keeps
            # running and publishes for the next caller)
            while not ev.wait(0.05):
                check_deadline("lookup sst build")
            # builder published (or failed — then we become the
            # builder on the next iteration and surface its error)
        try:
            t = load()
            if t is None:
                return None  # corrupt + scan.ignore-corrupt-files
            # spill even when EMPTY (all rows deleted/expired): the
            # empty SST is the negative cache — without it every
            # batch touching this bucket re-runs the full read
            return self._spill(key, t)
        finally:
            with self._build_lock:
                self._building.pop(key, None)
            ev.set()

    def _probe(self, key: str, load, lanes: np.ndarray,
               packed: Optional[np.ndarray] = None,
               hashes: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, pa.Table]:
        """Build-or-reuse + probe, tolerating a concurrent refresh
        evicting the SST file between get and probe (the local file
        vanishes -> OSError): drop the dead entry and rebuild once.

        Unlike the reference, a reader that the current plan no longer
        references (a batch on the previous plan rebuilt the SST of a
        file that compaction dropped) is dropped once it served that
        batch: it would otherwise stay on disk until the next snapshot
        change."""
        for attempt in (0, 1):
            reader = self._get_or_build(key, load)
            try:
                if reader is None or reader.num_rows == 0:
                    return np.zeros(0, np.int64), None
                return reader.probe(lanes, packed, hashes)
            except OSError as e:
                # route the retry decision through the fault taxonomy:
                # a deterministic decode error must surface, only the
                # transient flavor earns the one rebuild
                if attempt or not is_transient_error(e):
                    raise
                self.store.drop(key)
            finally:
                live = self._live_keys
                if live is not None and key not in live:
                    self.store.drop(key)

    def _file_reader_load(self, split, meta):
        """One data-file read for the lazy per-file SST (immutable
        thereafter — file names are uuid'd — so it survives snapshot
        advances until compaction drops the file)."""
        read_cols = list(dict.fromkeys(
            [f.name for f in self.table.schema.fields]
            + [SEQ_COL, KIND_COL]))
        return self._read._read_file(split, meta, read_cols)

    # -- lookup --------------------------------------------------------------

    def lookup(self, keys: Sequence[dict],
               partition: Tuple = ()) -> List[Optional[dict]]:
        """Batch point lookup: one dict of pk values per entry; returns
        the full row dict or None per key, in input order.  The whole
        batch resolves against ONE captured plan (no torn batches
        across a concurrent snapshot refresh); only the plan check
        itself takes the instance lock — reads, SST builds and probes
        run concurrently across serving threads.

        With a delta tier attached, every key probes the captured
        delta view FIRST: a hit (the newest unflushed write) or a
        tombstone answers without touching the LSM; misses fall
        through to the SST walk.  The view is captured BEFORE the plan
        (service/delta.py explains why that order is load-bearing)."""
        view = self._delta.view() if self._delta is not None else None
        splits, snap = self._check_snapshot()
        if not keys:
            return []
        rt = self.table.schema.logical_row_type()
        arrays = {k: pa.array([d[k] for d in keys],
                              data_type_to_arrow(rt.get_field(k).type))
                  for k in self.pk}
        query = pa.table(arrays)
        buckets = self.assigner.assign(query)
        out: List[Optional[dict]] = [None] * len(keys)
        pkey = self._pkey(self._norm_partition(partition))
        in_delta = np.zeros(len(keys), dtype=bool)
        if view is not None and not view.empty and view.touches(
                pkey, {int(b) for b in np.unique(buckets)}):
            # arrow-normalized key tuples (same normalization the
            # write side's to_pylist applied); the touches() gate
            # above keeps batches whose buckets hold no delta rows on
            # the pure vectorized path
            norm = query.to_pylist()
            for i, d in enumerate(norm):
                kt = tuple(d[k] for k in self.pk)
                hit = view.probe(pkey, int(buckets[i]), kt)
                if not view.is_miss(hit):
                    # hit row or tombstone (None): the newest write
                    # for this key — the LSM cannot hold anything
                    # newer under the single-serving-writer contract
                    out[i] = dict(hit) if hit is not None else None
                    in_delta[i] = True
            hits = int(in_delta.sum())
            if hits:
                self._m_delta_hits.inc(hits)
            if in_delta.all():
                return out
        # encode + pack + hash the WHOLE batch once; every probe below
        # slices these arrays (numpy views) instead of re-running the
        # arrow take / lane encode / splitmix fold per (bucket, run) —
        # at serving batch sizes that ceremony dominated the handler
        by_bucket: Dict[int, List[int]] = {}
        delta_flags = in_delta.tolist()
        for i, b in enumerate(buckets.tolist()):
            if not delta_flags[i]:
                by_bucket.setdefault(b, []).append(i)
        enc = None
        for b, idxs in by_bucket.items():
            split = splits.get((pkey, b))
            if split is None:
                continue         # empty bucket: all misses
            sel = np.array(idxs, dtype=np.int64)
            if enc is None:
                lanes_all = self._encode_lanes(query)
                packed_all = pack_lanes(lanes_all)
                enc = (lanes_all, packed_all, _key_hashes(packed_all))
            if self._fast_path_ok(split):
                self._lookup_runs(pkey, split, enc, sel, keys, out)
            else:
                self._lookup_merged(pkey, split, snap, enc, sel,
                                    keys, out)
        return out

    def _confirm(self, row: dict, q: dict) -> bool:
        # lanes may be prefix-truncated for long string keys: confirm
        # the full key before accepting the hit
        return all(row.get(k) == q[k] for k in self.pk)

    def _lookup_merged(self, pkey: str, split, snap, enc,
                       sel: np.ndarray, keys, out):
        """Merged-bucket fallback: the split's full merge-on-read
        result spilled as one SST (rows are final table rows — no
        kind/seq columns survive the merge)."""
        key = self._bucket_store_key(pkey, split, snap)
        _, packed_all, hashes_all = enc
        hit_pos, rows = self._probe(
            key, lambda: self._read.read_split(split),
            None, packed_all[sel], hashes_all[sel])
        if rows is None:
            return
        for qi, row in zip(hit_pos, rows.to_pylist()):
            q = keys[int(sel[qi])]
            if self._confirm(row, q):
                out[int(sel[qi])] = row

    def _lookup_runs(self, pkey: str, split, enc,
                     sel: np.ndarray, keys, out):
        """LSM point get: walk the bucket's sorted runs newest-first,
        prune files by manifest key-range stats before any IO, probe
        per-file SSTs (bloom + block binary search), stop at the first
        hit or tombstone per key."""
        _, packed_all, hashes_all = enc
        packed = packed_all[sel]
        hashes = hashes_all[sel]
        key_tuples = [tuple(d[k] for k in self.pk)
                      for d in (keys[int(i)] for i in sel)]
        pending = list(range(len(sel)))
        runs = assemble_runs(split.data_files)
        pruned = 0
        for run in reversed(runs):          # newest run first
            if not pending:
                break
            by_file: Dict[str, Tuple[object, List[int]]] = {}
            ranges = [(meta, self._file_range(meta)) for meta in run]
            for pos in pending:
                kt = key_tuples[pos]
                for meta, rng in ranges:
                    if self._in_range(kt, rng):
                        by_file.setdefault(
                            meta.file_name, (meta, []))[1].append(pos)
            pruned += len(run) - len(by_file)
            resolved: Dict[int, Optional[dict]] = {}
            for fname in sorted(by_file):
                meta, poss = by_file[fname]
                poss = [p for p in poss if p not in resolved]
                if not poss:
                    continue
                key = self._file_store_key(pkey, split.bucket, meta)
                if len(poss) == len(sel):
                    qp, qh = packed, hashes
                else:
                    idx = np.array(poss)
                    qp, qh = packed[idx], hashes[idx]
                hit_pos, rows = self._probe(
                    key,
                    lambda m=meta: self._file_reader_load(split, m),
                    None, qp, qh)
                if rows is None:
                    continue
                # highest sequence number wins within one file (a file
                # should hold one version per key; prefix-collided
                # lanes are filtered by the full-key confirm)
                best: Dict[int, Tuple[int, dict]] = {}
                for hp, row in zip(hit_pos, rows.to_pylist()):
                    pos = poss[int(hp)]
                    if not self._confirm(row, keys[int(sel[pos])]):
                        continue
                    seq = row.get(SEQ_COL) or 0
                    if pos not in best or seq >= best[pos][0]:
                        best[pos] = (seq, row)
                for pos, (_, row) in best.items():
                    kind = row.pop(KIND_COL, RowKind.INSERT)
                    row.pop(SEQ_COL, None)
                    if kind in (RowKind.UPDATE_BEFORE, RowKind.DELETE):
                        resolved[pos] = None      # tombstone
                    else:
                        resolved[pos] = row
            for pos, row in resolved.items():
                out[int(sel[pos])] = row
            pending = [p for p in pending if p not in resolved]
        if pruned:
            self._m_pruned.inc(pruned)

    def lookup_row(self, key: dict, partition: Tuple = ()
                   ) -> Optional[dict]:
        return self.lookup([key], partition)[0]
