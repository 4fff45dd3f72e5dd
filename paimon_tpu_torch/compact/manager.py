"""Compaction manager + rewriter for one (partition, bucket).

Counterpart of paimon_tpu/compact/manager.py; every merge, and the key
ranks of every changelog diff (ops/diff.py), run on the manager's torch
device.

reference: mergetree/compact/MergeTreeCompactManager.java:54
(triggerCompaction:136, submitCompaction:211), MergeTreeCompactTask.java:41
(doCompact:83 -- upgrade:124 metadata-only promotion vs rewrite),
MergeTreeCompactRewriter.java:78.

Deviation: the rewrite reads the unit's files to Arrow, merges the
whole bucket in one device kernel (no IntervalPartition sections -- the
sort absorbs arbitrary overlap), and rolls the result into output-level
files. Drop-delete applies when the output is the highest non-empty level.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import pyarrow as pa
import pyarrow.compute as pc

from paimon_tpu_torch.compact.levels import Levels
from paimon_tpu_torch.compact.universal import (
    CompactUnit, UniversalCompaction, pick_full_compaction,
)
from paimon_tpu_torch.core.kv_file import (
    KEY_PREFIX, KeyValueFileWriter, read_kv_file, write_changelog_file,
)
from paimon_tpu_torch.core.read import assemble_runs
from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.manifest import DataFileMeta, FileSource
from paimon_tpu_torch.metrics import (
    SCAN_DEVICE_DECODE_FALLBACKS, CompactTimer, global_registry,
)
from paimon_tpu_torch.options import ChangelogProducer, CoreOptions, MergeEngine
from paimon_tpu_torch.ops.agg import merge_runs_agg
from paimon_tpu_torch.ops.diff import keyed_changelog_diff
from paimon_tpu_torch.ops.merge import KIND_COL, merge_runs
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.types import RowKind, data_type_to_arrow
from paimon_tpu_torch.utils.path_factory import FileStorePathFactory

__all__ = ["MergeTreeCompactManager", "CompactResult"]


@dataclass
class CompactResult:
    before: List[DataFileMeta]
    after: List[DataFileMeta]
    changelog: List[DataFileMeta] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.before and not self.after and not self.changelog


def _prefetch(it, depth: int = 2):
    """Run a chunk iterator in a background thread with a small bounded
    queue so file decode overlaps the merge kernel (decode releases the
    GIL). One thread per sorted run of a streamed rewrite.  The pump
    polls a cancel flag on every bounded put, so a consumer that
    abandons the generator early (merge error elsewhere) releases the
    thread and its pinned chunks instead of leaking them."""
    import queue as _queue
    import threading as _threading

    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    _SENTINEL = object()
    cancelled = _threading.Event()

    def pump():
        try:
            for item in it:
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if cancelled.is_set():
                    return
            q.put(_SENTINEL)
        except BaseException as e:       # noqa: BLE001
            if not cancelled.is_set():
                q.put(("__prefetch_error__", e))

    from paimon_tpu_torch.parallel.executors import spawn_thread
    spawn_thread(pump, name="paimon-prefetch-pump")
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, tuple) and len(item) == 2 and \
                    item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        cancelled.set()


# compactions of every bucket share one busy window: managers live for
# one task, and the gauge stays bound to the first timer it was given
_BUSY_TIMER = CompactTimer()


class MergeTreeCompactManager:
    def __init__(self, file_io: FileIO, table_path: str,
                 schema: TableSchema, options: CoreOptions,
                 partition: Tuple, bucket: int,
                 files: List[DataFileMeta], schema_manager=None,
                 device=None):
        self.file_io = file_io
        self.device = device
        self.schema = schema
        self.options = options
        self.partition = partition
        self.bucket = bucket
        self.schema_manager = schema_manager
        self._schema_cache = {schema.id: schema}
        self._file_cache: dict = {}
        self.levels = Levels(files, options.num_levels)
        self.strategy = UniversalCompaction(
            max_size_amp=options.max_size_amplification_percent,
            size_ratio=options.size_ratio,
            num_run_trigger=options.num_sorted_runs_compaction_trigger,
            total_size_threshold=options.get(
                CoreOptions.COMPACTION_TOTAL_SIZE_THRESHOLD),
            file_num_limit=options.get(
                CoreOptions.COMPACTION_FILE_NUM_LIMIT),
            offpeak_hours=(
                options.get(CoreOptions.COMPACTION_OFFPEAK_START_HOUR),
                options.get(CoreOptions.COMPACTION_OFFPEAK_END_HOUR)),
            offpeak_ratio=options.get(
                CoreOptions.COMPACTION_OFFPEAK_RATIO))
        self.path_factory = FileStorePathFactory.from_options(
            table_path, schema.partition_keys, options)
        self.kv_writer = KeyValueFileWriter(
            file_io, self.path_factory, schema,
            file_format=options.file_format,
            compression=options.file_compression,
            target_file_size=options.target_file_size,
            index_spec=options.file_index_spec,
            bloom_fpp=options.get(CoreOptions.FILE_INDEX_BLOOM_FPP),
            index_in_manifest_threshold=options.get(
                CoreOptions.FILE_INDEX_IN_MANIFEST_THRESHOLD),
            format_per_level=options.file_format_per_level,
            format_options=options.format_options,
            **options.kv_writer_kwargs())
        rt = schema.logical_row_type()
        self.trimmed_pk = schema.trimmed_primary_keys()
        self.key_cols = [KEY_PREFIX + k for k in self.trimmed_pk]
        self.key_encoder = NormalizedKeyEncoder(
            [data_type_to_arrow(rt.get_field(k).type)
             for k in self.trimmed_pk],
            nullable=[rt.get_field(k).type.nullable
                      for k in self.trimmed_pk])

    # -- picking -------------------------------------------------------------

    def pick(self, full: bool = False) -> Optional[CompactUnit]:
        runs = self.levels.level_sorted_runs()
        if full:
            return pick_full_compaction(
                self.options.num_levels, runs,
                force_rewrite_all=self.options.get(
                    CoreOptions.COMPACTION_FORCE_REWRITE_ALL_FILES))
        return self.strategy.pick(self.options.num_levels, runs)

    # -- execution -----------------------------------------------------------

    def compact(self, full: bool = False) -> Optional[CompactResult]:
        unit = self.pick(full)
        if unit is None or not unit.files:
            return None
        return self.do_compact(unit)

    def do_compact(self, unit: CompactUnit) -> CompactResult:
        """reference MergeTreeCompactTask.doCompact:83, timed into the
        compaction metric group."""
        group = global_registry().compaction_metrics()
        group.gauge("busy_ratio_1m", _BUSY_TIMER.busy_ratio)
        _BUSY_TIMER.start()
        t0 = time.perf_counter()
        try:
            result = self._do_compact(unit)
        finally:
            _BUSY_TIMER.stop()
            group.histogram("duration_ms").update(
                (time.perf_counter() - t0) * 1000)
            group.counter("tasks").inc()
        group.counter("input_files").inc(len(unit.files))
        group.counter("output_files").inc(len(result.after))
        return result

    def _do_compact(self, unit: CompactUnit) -> CompactResult:
        files = unit.files
        producer = self.options.changelog_producer
        # upgrade fast path: single file, no rewrite needed. Both
        # compaction changelog producers must force a rewrite instead:
        # lookup for any L0 promotion (its keys were never changelog'd),
        # full-compaction when promoting INTO the top level (reference
        # FullChangelogMergeTreeCompactRewriter.upgradeChangelog)
        force_rewrite = self.options.get(
            CoreOptions.COMPACTION_FORCE_REWRITE_ALL_FILES)
        if len(files) == 1 and not force_rewrite:
            f = files[0]
            if f.level == unit.output_level:
                return CompactResult([], [])
            blocked = (
                (producer == ChangelogProducer.LOOKUP and f.level == 0)
                or (producer == ChangelogProducer.FULL_COMPACTION
                    and unit.output_level == self.levels.max_level
                    and f.level == 0)
                # deferred-merge engines (partial-update / aggregation)
                # sort but do NOT merge at L0 flush (core/write.py flush),
                # so an L0 file may hold several versions of one key;
                # promoting it without rewrite would let raw-convertible
                # reads surface the duplicates
                or (f.level == 0 and self.options.merge_engine in
                    (MergeEngine.PARTIAL_UPDATE, MergeEngine.AGGREGATE))
                # file.format.per.level: a metadata-only promotion would
                # carry the wrong format into the target level
                # (reference upgrade rewrites on format change)
                or (self.kv_writer.format_per_level and
                    self.kv_writer.format_per_level.get(
                        unit.output_level,
                        self.options.file_format.lower())
                    != f.file_name.rsplit(".", 1)[-1].lower()))
            # metadata-only promotion unless deletes must be dropped at the
            # top level (reference MergeTreeCompactTask.upgrade:124)
            if (unit.output_level < self.levels.max_level
                    or (f.delete_row_count or 0) == 0) and not blocked:
                upgraded = f.upgrade(unit.output_level)
                return CompactResult([f], [upgraded])

        drop_delete = (unit.output_level != 0
                       and unit.output_level
                       >= self.levels.non_empty_highest_level())
        total_rows = sum(f.row_count for f in files)
        threshold = self.options.get(
            CoreOptions.MERGE_STREAM_THRESHOLD_ROWS)
        if producer == ChangelogProducer.NONE and total_rows > threshold:
            # bounded-memory path: stream key windows through the kernel
            after = self._rewrite_streamed(files, unit.output_level,
                                           drop_delete)
            return CompactResult(list(files), after)
        merged = self._merged_state(files, drop_deletes=drop_delete)
        after = self.kv_writer.write(self.partition, self.bucket, merged,
                                     level=unit.output_level,
                                     file_source=FileSource.COMPACT)
        changelog = self._produce_changelog(unit, merged, drop_delete)
        return CompactResult(list(files), after, changelog)

    def _rewrite_streamed(self, files: List[DataFileMeta],
                          output_level: int,
                          drop_delete: bool) -> List[DataFileMeta]:
        """Streamed whole-bucket rewrite (ops/merge_stream.py): peak
        memory ~ runs x chunk + one key window, independent of bucket
        size — SURVEY hard part (d)."""
        from paimon_tpu_torch.core.read import evolve_table
        from paimon_tpu_torch.format import get_format
        from paimon_tpu_torch.format.rawpage import maybe_iter_batches_device
        from paimon_tpu_torch.fs.caching import scoped_batches
        from paimon_tpu_torch.ops.merge_stream import merge_runs_streamed

        chunk_rows = self.options.get(CoreOptions.MERGE_CHUNK_ROWS)
        runs_meta = assemble_runs(files)

        device_decode = self.options.get(CoreOptions.READ_DEVICE_DECODE)
        from paimon_tpu_torch.format.blob import blob_column_names
        has_blobs = bool(blob_column_names(self.schema))

        def batches_of(f):
            if has_blobs:
                # blob descriptors must resolve against the whole
                # sidecar: read this file unstreamed (bounded by
                # target-file-size), still windowed downstream
                return [read_kv_file(self.file_io, self.path_factory,
                                     self.partition, self.bucket, f,
                                     schema=self.schema,
                                     schema_manager=self.schema_manager,
                                     options=self.options,
                                     device=self.device)]
            ext = f.file_name.rsplit(".", 1)[-1]
            fmt = get_format(ext)
            path = f.external_path or self.path_factory.data_file_path(
                self.partition, self.bucket, f.file_name)
            if fmt.identifier == "parquet" and device_decode:
                # row group by row group through the device decode
                # plane, keeping the streamed path's memory bound; a
                # file outside coverage takes read_batches below
                batches = maybe_iter_batches_device(
                    self.file_io, path, chunk_rows, self.options,
                    device=self.device)
                if batches is not None:
                    return batches
                global_registry().scan_metrics().counter(
                    SCAN_DEVICE_DECODE_FALLBACKS).inc()
            # scoped_batches holds the footer-cache gate only while
            # advancing the reader, never across this generator's yields
            return scoped_batches(fmt.create_reader().read_batches(
                self.file_io, path, batch_rows=chunk_rows), self.options)

        def run_iter(run_files):
            # yields (table, lanes, truncated, packed): the lane encode
            # runs HERE, inside the prefetch thread, overlapping the merge
            for f in run_files:
                for batch in batches_of(f):
                    t = evolve_table(batch, f.schema_id, self.schema,
                                     self.schema_manager,
                                     self._schema_cache,
                                     keep_sys_cols=True)
                    yield (t, *self.key_encoder.encode_table_ex(
                        t, self.key_cols))

        # three-stage pipeline: prefetch threads decode+lane-encode,
        # merge workers sort/dedup windows on the device (upload, sort
        # and download overlap the next window's decode and cut), and a
        # write pool encodes output files.
        # Futures are consumed in submission order at every stage, so
        # output files stay in key order regardless of completion.
        futures = []
        acc: List[pa.Table] = []
        acc_bytes = 0

        def _write_one(merged: pa.Table) -> List[DataFileMeta]:
            return self.kv_writer.write(
                self.partition, self.bucket, merged, level=output_level,
                file_source=FileSource.COMPACT)

        # two merge workers: device work and the numpy epilogues release
        # the GIL, so adjacent windows overlap; both launch on the
        # current stream of the device; futures are still consumed in
        # submission order so output files stay in key order
        with ThreadPoolExecutor(max_workers=3) as pool, \
                ThreadPoolExecutor(max_workers=2) as merge_pool:

            def merge_window(items):
                tables = [item[0] for item in items]
                encoded = [item[1:] for item in items]
                return merge_pool.submit(
                    self._merge_tables, tables, drop_delete,
                    encoded=encoded, overlapped=True)

            def flush():
                nonlocal acc, acc_bytes
                if not acc:
                    return
                # surface an already-failed write now instead of merging
                # every remaining window first
                for f in futures:
                    if f.done() and f.exception() is not None:
                        f.result()
                # backpressure: at most 3 file-sized tables in flight so
                # a slow disk can't unbound the streamed path's memory
                pending = [f for f in futures if not f.done()]
                if len(pending) >= 3:
                    pending[0].result()
                merged = pa.concat_tables(acc, promote_options="none")
                futures.append(pool.submit(_write_one, merged))
                acc, acc_bytes = [], 0

            merge_futs: List = []

            def _collect(fut) -> None:
                nonlocal acc_bytes
                window = fut.result()
                if window.num_rows == 0:
                    return
                acc.append(window)
                acc_bytes += window.nbytes
                if acc_bytes >= self.kv_writer.target_file_size:
                    flush()

            def emit(fut):
                merge_futs.append(fut)
                # collect any already-finished merges in order, and cap
                # the lookahead at 2 windows so memory stays bounded
                while merge_futs and (merge_futs[0].done()
                                      or len(merge_futs) > 2):
                    _collect(merge_futs.pop(0))

            merge_runs_streamed(
                [_prefetch(run_iter(rf)) for rf in runs_meta],
                self.key_cols, self.key_encoder, emit, merge_window,
                pass_encoded=True,
                window_rows=self.options.get(
                    CoreOptions.MERGE_WINDOW_ROWS))
            while merge_futs:
                _collect(merge_futs.pop(0))
            flush()
            out: List[DataFileMeta] = []
            for f in futures:
                out.extend(f.result())
        return out

    # -- changelog producers -------------------------------------------------

    def _produce_changelog(self, unit: CompactUnit, merged: pa.Table,
                           drop_delete: bool) -> List[DataFileMeta]:
        producer = self.options.changelog_producer
        value_cols = [f.name for f in self.schema.fields]
        cl = None
        if producer == ChangelogProducer.FULL_COMPACTION and \
                unit.output_level == self.levels.max_level:
            # diff previous top level vs the new full result
            # (reference FullChangelogMergeTreeCompactRewriter)
            top = self.levels.levels.get(self.levels.max_level)
            before = self._merged_state(top.files) \
                if top and top.files else None
            live = merged if drop_delete else self._live_view(merged)
            cl = keyed_changelog_diff(before, live, self.key_cols,
                                      self.key_encoder, value_cols,
                                      device=self.device)
        elif producer == ChangelogProducer.LOOKUP:
            # the reference's lookup producer changelogs EVERY commit
            # (LookupChangelogMergeFunctionWrapper.java:54); batched at
            # compaction time, completeness demands replaying the L0
            # deltas in commit order against an evolving state — one
            # aggregate before/after diff would silently swallow a key
            # that was inserted AND deleted between two compactions
            # (its +I was visible to any from-snapshot-full consumer)
            l0 = sorted((f for f in unit.files if f.level == 0),
                        key=lambda f: (f.max_sequence_number,
                                       f.min_sequence_number))
            if l0:
                all_files = self.levels.all_files()
                self._read_runs(l0, flatten=True)   # warm via the pool
                state = self._merged_state(
                    [f for f in all_files if f.level > 0])
                pieces = []
                for f in l0:
                    delta = self._read_runs([f], flatten=True)[0]
                    runs = ([state] if state is not None and
                            state.num_rows else []) + [delta]
                    # ENGINE-AWARE replay: the evolving state must merge
                    # exactly like the table (partial-update/aggregation
                    # fold, not last-write-wins)
                    new_state = self._merge_tables(runs,
                                                   drop_deletes=True)
                    piece = keyed_changelog_diff(
                        state, new_state, self.key_cols,
                        self.key_encoder, value_cols,
                        restrict_table=delta, device=self.device)
                    if piece.num_rows:
                        pieces.append(piece)
                    state = new_state
                if pieces:
                    cl = pa.concat_tables(pieces,
                                          promote_options="none")
        if cl is None or cl.num_rows == 0:
            return []
        return write_changelog_file(
            self.file_io, self.path_factory, self.schema,
            self.options.changelog_file_format,
            self.options.changelog_file_compression,
            self.partition, self.bucket, cl,
            prefix=self.options.changelog_file_prefix,
            format_options=self.options.format_options)

    # -- merged-state helpers ------------------------------------------------

    def _read_file(self, f: DataFileMeta) -> pa.Table:
        """Read+evolve one data file, memoized: changelog producers walk
        overlapping file sets (unit, levels>0, all, L0), so each file is
        decoded at most once per compaction."""
        from paimon_tpu_torch.core.read import evolve_table

        cached = self._file_cache.get(f.file_name)
        if cached is not None:
            return cached
        raw = read_kv_file(self.file_io, self.path_factory, self.partition,
                           self.bucket, f, schema=self.schema,
                           schema_manager=self.schema_manager,
                           options=self.options, device=self.device)
        t = evolve_table(raw, f.schema_id, self.schema,
                         self.schema_manager, self._schema_cache,
                         keep_sys_cols=True)
        self._file_cache[f.file_name] = t
        return t

    def _read_runs(self, files: List[DataFileMeta],
                   flatten: bool = False) -> List[pa.Table]:
        runs_meta = assemble_runs(files)
        # parquet decode releases the GIL: fan the uncached file reads
        # over a small thread pool
        flat = [f for rf in runs_meta for f in rf]
        uncached = [f for f in flat
                    if f.file_name not in self._file_cache]
        if len(uncached) > 1:
            with ThreadPoolExecutor(
                    max_workers=min(8, len(uncached))) as pool:
                list(pool.map(self._read_file, uncached))
        runs = []
        for run_files in runs_meta:
            tables = [self._read_file(f) for f in run_files]
            if flatten:
                runs.extend(tables)
            else:
                runs.append(pa.concat_tables(tables,
                                             promote_options="none")
                            if len(tables) > 1 else tables[0])
        return runs

    def _live_view(self, merged: pa.Table) -> pa.Table:
        kinds = merged.column(KIND_COL).combine_chunks().cast(pa.int8())
        keep = pc.or_(pc.equal(kinds, RowKind.INSERT),
                      pc.equal(kinds, RowKind.UPDATE_AFTER))
        return merged.filter(keep)

    def _record_level_expire(self, merged: pa.Table) -> pa.Table:
        from paimon_tpu_torch.core.read import record_level_expire_filter
        return record_level_expire_filter(self.options, merged)

    def _merge_tables(self, run_tables: List[pa.Table],
                      drop_deletes: bool, encoded=None,
                      overlapped: bool = False) -> pa.Table:
        """Merge run-ordered tables under the table's merge engine —
        the single dispatch shared by the one-shot and streamed paths.
        `encoded`: optional pre-computed (lanes, truncated[, packed])
        per table (the streamed path encodes once for the window cut).
        `overlapped`: the caller runs merges on a pipeline worker, so
        device transfers hide under the next window's decode and cut
        (the bitmask route's cost model)."""
        engine = self.options.merge_engine
        seq_fields = self.options.sequence_field or None
        if engine in (MergeEngine.DEDUPLICATE, MergeEngine.FIRST_ROW):
            res = merge_runs(
                run_tables, self.key_cols, merge_engine=engine,
                drop_deletes=drop_deletes, key_encoder=self.key_encoder,
                seq_fields=seq_fields,
                seq_desc=self.options.sequence_field_descending,
                encoded=encoded, overlapped=overlapped,
                device=self.device)
            return self._record_level_expire(res.take())
        merged = merge_runs_agg(run_tables, self.key_cols, self.schema,
                                self.options,
                                key_encoder=self.key_encoder,
                                seq_fields=seq_fields, encoded=encoded,
                                device=self.device)
        if drop_deletes:
            merged = self._live_view(merged)
        return self._record_level_expire(merged)

    def _merged_state(self, files: List[DataFileMeta],
                      drop_deletes: bool = True) -> Optional[pa.Table]:
        """KV-shaped, key-sorted, key-unique merged state of `files`."""
        if not files:
            return None
        return self._merge_tables(self._read_runs(files), drop_deletes)
