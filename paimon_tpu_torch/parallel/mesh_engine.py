"""Streaming mesh compaction engine: every merge engine, bounded key
windows, skew-aware bucket packing, per-bucket fault isolation.

Counterpart of paimon_tpu/parallel/mesh_engine.py.

1. ENGINE DISPATCH.  The window merge takes the table's engine:
   deduplicate and first-row consume the winner mask; aggregation and
   partial-update feed the sorted order and segment ends to the same
   epilogue the single-chip path runs (ops/agg.py
   aggregate_sorted_segments), so the mesh output equals the
   single-chip output row for row.  Other engines raise
   UnsupportedMergeEngineError, never a silent deduplicate.
2. BOUNDED WINDOWS.  Buckets stream through the mesh in key windows
   (ops/merge_stream.iter_merge_windows lifted to [B, window]): each
   mesh step stacks one window per lane, so host memory per bucket is
   about runs x window rows, whatever the bucket's size.  Window rows
   pad to a power of two.
3. SKEW-AWARE PACKING.  Buckets pack onto the lanes by manifest row
   counts (parallel/packing.py): a hot bucket holds one lane while the
   cold ones share the rest.
4. PER-BUCKET FAULT ISOLATION.  A transient error anywhere in one
   bucket's window stream aborts and retries that bucket with jittered
   backoff, then degrades it to the single-chip compact/manager.py path
   (parallel/fault.py).  A failed attempt's output files are deleted
   first, so the commit equals a fault-free run's file for file.

A mesh step is one batched merge on the mesh's device
(`_MeshWindowKernel`): a stable sort per lane and ONE launch of the
winner-select's offset-value-code variant (K2) over all lanes, fed the
run codes of every lane's window (ops/ovc.run_ovc_offsets, on the
host).  The device sees fixed-width key lanes and sequence halves only;
variable-width Arrow data stays on the host, and output files roll per
bucket as windows emit.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paimon_tpu_torch.options import (
    ChangelogProducer, CoreOptions, MergeEngine,
)
from paimon_tpu_torch.parallel.packing import (
    bucket_row_counts, pack_buckets, packing_skew,
)

__all__ = ["UnsupportedMergeEngineError", "MeshCompactStats",
           "compact_table_mesh", "SUPPORTED_MERGE_ENGINES"]

SUPPORTED_MERGE_ENGINES = (
    MergeEngine.DEDUPLICATE, MergeEngine.PARTIAL_UPDATE,
    MergeEngine.AGGREGATE, MergeEngine.FIRST_ROW,
)


class UnsupportedMergeEngineError(ValueError):
    """A mesh compaction path was asked to run a merge engine it has no
    merge for; raised instead of silently deduplicating."""


@dataclass
class MeshCompactStats:
    buckets: int = 0            # buckets that needed a rewrite
    lanes: int = 0              # mesh lanes
    input_rows: int = 0         # manifest row count over rewritten files
    output_rows: int = 0
    windows: int = 0            # window merges on the mesh
    peak_window_rows: int = 0   # largest single window (before padding)
    peak_buffered_rows: int = 0  # max per-bucket run-buffer rows
    skew: float = 1.0           # max/mean lane load after packing
    snapshot_id: Optional[int] = None
    lane_rows: List[int] = dc_field(default_factory=list)
    retries: int = 0            # per-bucket transient-failure retries
    fallbacks: int = 0          # buckets degraded to single-chip
    cleanup_errors: int = 0     # best-effort partial-file deletes failed


def _single_process(mesh) -> None:
    """Table-level mesh compaction runs in one process: a multi-process
    plane (each rank committing its own buckets) is
    parallel/distributed.py, which is not ported yet."""
    if mesh.world > 1:
        raise NotImplementedError(
            "table compaction over a multi-process mesh is not ported to "
            "paimon_tpu_torch yet (ROADMAP.md: A.8.9)")


# ---------------------------------------------------------------------------
# window merge: the batched segmented merge over [B, N]
# ---------------------------------------------------------------------------


class _MeshWindowKernel:
    """Engine-parameterized window merge over a [B, N] lane stack.

    __call__(lanes[B,N,L], seq_hi[B,N], seq_lo[B,N], invalid[B,N],
    ovc_off[B,N]) -> (perm[B,N], winner[B,N], total winners summed over
    the mesh).  `keep` selects the winner row per key segment (last =
    deduplicate, partial-update and aggregation segment ends, first =
    first-row); the first `num_key_lanes` lanes define segment identity,
    further lanes are user-defined sequence order."""

    def __init__(self, mesh, num_key_lanes: int, keep: str):
        self.mesh = mesh
        self.num_key_lanes = num_key_lanes
        self.keep = keep

    def __call__(self, lanes: np.ndarray, seq_hi: np.ndarray,
                 seq_lo: np.ndarray, invalid: np.ndarray,
                 ovc_off: np.ndarray):
        from paimon_tpu_torch.parallel.sharded_merge import device_merge

        perm, winner = device_merge(self.mesh, lanes, seq_hi, seq_lo,
                                    invalid, self.keep,
                                    num_key_lanes=self.num_key_lanes,
                                    ovc_off=ovc_off)
        total = self.mesh.psum(winner.sum(dtype=torch.int64))
        perm, winner = self.mesh.gather(perm), self.mesh.gather(winner)
        return perm.cpu().numpy(), winner.cpu().numpy(), int(total)


# ---------------------------------------------------------------------------
# engine context + per-bucket streamed jobs
# ---------------------------------------------------------------------------


class _EngineContext:
    """Per-run bundle: reader/writer planes, key encoding, engine mode."""

    def __init__(self, table):
        from paimon_tpu_torch.core.kv_file import KeyValueFileWriter
        from paimon_tpu_torch.core.read import MergeFileSplitRead
        from paimon_tpu_torch.format.blob import blob_column_names

        self.table = table
        self.device = table.device
        self.schema = table.schema
        self.options = table.options
        self.schema_manager = table.schema_manager
        self.schema_cache = {table.schema.id: table.schema}
        reader = MergeFileSplitRead(table.file_io, table.path, table.schema,
                                    table.options)
        self.key_cols = reader.key_cols
        self.key_encoder = reader.key_encoder
        self.path_factory = reader.path_factory
        opts = table.options
        self.writer = KeyValueFileWriter(
            table.file_io, self.path_factory, table.schema,
            file_format=opts.file_format, compression=opts.file_compression,
            target_file_size=opts.target_file_size,
            index_spec=opts.file_index_spec,
            bloom_fpp=opts.get(CoreOptions.FILE_INDEX_BLOOM_FPP),
            format_per_level=opts.file_format_per_level,
            format_options=opts.format_options, **opts.kv_writer_kwargs())
        self.max_level = opts.max_level
        self.chunk_rows = opts.get(CoreOptions.MESH_WINDOW_ROWS)
        self.has_blobs = bool(blob_column_names(table.schema))
        self.engine = opts.merge_engine
        self.keep = "first" if self.engine == MergeEngine.FIRST_ROW \
            else "last"
        self.seq_fields = opts.sequence_field or None
        self.seq_desc = opts.sequence_field_descending
        # lane geometry, fixed for the whole run
        self.num_key_lanes = sum(self.key_encoder.lanes_per_col)
        self.num_order_lanes = 0
        if self.seq_fields:
            from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
            from paimon_tpu_torch.types import data_type_to_arrow
            rt = table.schema.logical_row_type()
            enc = NormalizedKeyEncoder(
                [data_type_to_arrow(rt.get_field(f).type)
                 for f in self.seq_fields],
                nullable=[True] * len(self.seq_fields))
            self.num_order_lanes = sum(enc.lanes_per_col)
        self.num_lanes = self.num_key_lanes + self.num_order_lanes

    # -- engine-specific window epilogues (host side) -----------------------

    def live_filter(self, merged):
        """Full compaction keeps only rows whose surviving kind is +I or
        +U, as the single-chip manager's _live_view."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from paimon_tpu_torch.ops.merge import KIND_COL
        from paimon_tpu_torch.types import RowKind

        kinds = merged.column(KIND_COL).combine_chunks().cast(pa.int8())
        keep = pc.or_(pc.equal(kinds, RowKind.INSERT),
                      pc.equal(kinds, RowKind.UPDATE_AFTER))
        return merged.filter(keep)

    def expire_filter(self, merged):
        from paimon_tpu_torch.core.read import record_level_expire_filter
        return record_level_expire_filter(self.options, merged)

    def merge_window_host(self, items):
        """Exact single-chip merge of one window: the route of windows
        holding prefix-truncated keys (their repair lives in the
        single-chip merge) and of empty windows."""
        from paimon_tpu_torch.ops.agg import merge_runs_agg
        from paimon_tpu_torch.ops.merge import merge_runs

        tables = [it[0] for it in items]
        encoded = [it[1:] for it in items]
        if self.engine in (MergeEngine.DEDUPLICATE, MergeEngine.FIRST_ROW):
            merged = merge_runs(
                tables, self.key_cols,
                merge_engine=("first-row"
                              if self.engine == MergeEngine.FIRST_ROW
                              else "deduplicate"),
                drop_deletes=True, key_encoder=self.key_encoder,
                seq_fields=self.seq_fields, seq_desc=self.seq_desc,
                encoded=encoded, device=self.device).take()
        else:
            merged = self.live_filter(merge_runs_agg(
                tables, self.key_cols, self.schema, self.options,
                key_encoder=self.key_encoder, seq_fields=self.seq_fields,
                device=self.device))
        return self.expire_filter(merged)

    def merge_window_device(self, wtable, perm_row: np.ndarray,
                            winner_row: np.ndarray):
        """Fold one window given the mesh merge's sorted order."""
        import pyarrow as pa

        from paimon_tpu_torch.ops.merge import KIND_COL
        from paimon_tpu_torch.types import RowKind

        n = wtable.num_rows
        if self.engine in (MergeEngine.DEDUPLICATE, MergeEngine.FIRST_ROW):
            indices = perm_row[np.flatnonzero(winner_row)].astype(np.int64)
            kinds = np.asarray(wtable.column(KIND_COL).combine_chunks()
                               .cast(pa.int8()))
            keep_mask = (kinds[indices] == RowKind.INSERT) | \
                        (kinds[indices] == RowKind.UPDATE_AFTER)
            return self.expire_filter(wtable.take(pa.array(
                indices[keep_mask])))
        # aggregation / partial-update: the merge's order and segment
        # ends feed the single-chip aggregation epilogue
        from paimon_tpu_torch.ops.agg import aggregate_sorted_segments

        real = perm_row < n
        order = perm_row[real].astype(np.int64)
        win_sorted = np.asarray(winner_row[real], dtype=bool)
        if len(win_sorted):
            win_sorted[-1] = True
            seg_id = np.concatenate(
                [[0], np.cumsum(win_sorted[:-1])]).astype(np.int64)
        else:
            seg_id = np.zeros(0, np.int64)
        merged = aggregate_sorted_segments(
            wtable, order, seg_id, win_sorted, self.key_cols, self.schema,
            self.options, device=self.device)
        return self.expire_filter(self.live_filter(merged))


class _BucketJob:
    """One (partition, bucket)'s streamed full rewrite: a window
    iterator over its sorted runs plus a rolling output-file writer."""

    def __init__(self, ctx: _EngineContext, split):
        self.ctx = ctx
        self.split = split
        self.files = list(split.data_files)
        self.stream_stats: Dict[str, int] = {}
        self.acc: List = []
        self.acc_bytes = 0
        self.metas: List = []
        self.out_rows = 0
        self._windows = None
        # a retried bucket is requeued with a not-before deadline
        # (monotonic seconds) instead of sleeping the whole mesh
        self.ready_at = 0.0

    def _run_iter(self, run_files):
        """Decode one sorted run in bounded chunks, lane-encoding inside
        the prefetch thread (the single-chip streamed rewrite's shape)."""
        from paimon_tpu_torch.core.kv_file import read_kv_file
        from paimon_tpu_torch.core.read import evolve_table
        from paimon_tpu_torch.format import get_format
        from paimon_tpu_torch.fs.caching import scoped_batches

        ctx = self.ctx
        options = ctx.options
        split = self.split

        def item(t, f):
            t = evolve_table(t, f.schema_id, ctx.schema, ctx.schema_manager,
                             ctx.schema_cache, keep_sys_cols=True)
            return (t, *ctx.key_encoder.encode_table_ex(t, ctx.key_cols))

        for f in run_files:
            if ctx.has_blobs:
                # blob descriptors resolve against the whole sidecar:
                # the file is read unstreamed
                yield item(read_kv_file(ctx.table.file_io, ctx.path_factory,
                                        split.partition, split.bucket, f,
                                        schema=ctx.schema,
                                        schema_manager=ctx.schema_manager,
                                        options=options,
                                        device=ctx.device), f)
                continue
            fmt = get_format(f.file_name.rsplit(".", 1)[-1])
            path = f.external_path or ctx.path_factory.data_file_path(
                split.partition, split.bucket, f.file_name)
            batches = None
            if fmt.identifier == "parquet" and options.get(
                    CoreOptions.READ_DEVICE_DECODE):
                # row group by row group through the device decode plane
                # (the batch path's memory bound); a file outside its
                # coverage takes the format reader below, counted in
                # rawpage.DECODE_COUNTS and in the scan metric
                from paimon_tpu_torch.format.rawpage import (
                    maybe_iter_batches_device,
                )
                batches = maybe_iter_batches_device(
                    ctx.table.file_io, path, ctx.chunk_rows, options,
                    device=ctx.device)
                if batches is None:
                    from paimon_tpu_torch.metrics import (
                        SCAN_DEVICE_DECODE_FALLBACKS, global_registry,
                    )
                    global_registry().scan_metrics().counter(
                        SCAN_DEVICE_DECODE_FALLBACKS).inc()
            if batches is None:
                # the footer-cache gate is held only while advancing the
                # reader, never across these yields
                batches = scoped_batches(fmt.create_reader().read_batches(
                    ctx.table.file_io, path, batch_rows=ctx.chunk_rows),
                    options)
            for batch in batches:
                yield item(batch, f)

    def next_window(self):
        """Next run-ordered item list, or None when the bucket drains."""
        if self._windows is None:
            from paimon_tpu_torch.compact.manager import _prefetch
            from paimon_tpu_torch.core.read import assemble_runs
            from paimon_tpu_torch.ops.merge_stream import iter_merge_windows

            self._windows = iter_merge_windows(
                [_prefetch(self._run_iter(rf))
                 for rf in assemble_runs(self.files)],
                self.ctx.key_cols, self.ctx.key_encoder,
                stats=self.stream_stats,
                window_rows=self.ctx.options.get(
                    CoreOptions.MERGE_WINDOW_ROWS))
        return next(self._windows, None)

    def emit(self, merged) -> None:
        if merged.num_rows == 0:
            return
        self.out_rows += merged.num_rows
        self.acc.append(merged)
        self.acc_bytes += merged.nbytes
        if self.acc_bytes >= self.ctx.writer.target_file_size:
            self.flush()

    def flush(self) -> None:
        if not self.acc:
            return
        import pyarrow as pa

        from paimon_tpu_torch.manifest import FileSource

        merged = pa.concat_tables(self.acc, promote_options="none") \
            if len(self.acc) > 1 else self.acc[0]
        self.acc, self.acc_bytes = [], 0
        self.metas.extend(self.ctx.writer.write(
            self.split.partition, self.split.bucket, merged,
            level=self.ctx.max_level, file_source=FileSource.COMPACT))


class _LaneState:
    """A mesh lane's queue of bucket jobs; at most one is streaming."""

    def __init__(self, jobs: List[_BucketJob]):
        self.queue = list(jobs)
        self.current: Optional[_BucketJob] = None

    def next_window(self, finalize):
        """(job, window items) for this lane's next window; None when
        the lane has drained or every queued job is inside its retry
        backoff.  Finished buckets flush and finalize before the lane
        moves on."""
        while True:
            if self.current is None:
                now = _time.monotonic()
                ready = next((j for j in self.queue if j.ready_at <= now),
                             None)
                if ready is None:
                    return None
                self.queue.remove(ready)
                self.current = ready
            w = self.current.next_window()
            if w is not None:
                return (self.current, w)
            finalize(self.current)
            self.current = None


# ---------------------------------------------------------------------------
# table-level entry
# ---------------------------------------------------------------------------


def _needs_rewrite(split, max_level: int) -> bool:
    """The single-chip manager's no-op condition: one file already at
    the top level with no deletes has nothing to fold."""
    fs = split.data_files
    return not (len(fs) == 1 and fs[0].level == max_level
                and (fs[0].delete_row_count or 0) == 0)


def compact_table_mesh(table, mesh=None, retry_policy=None
                       ) -> MeshCompactStats:
    """Full compaction of every bucket of a primary-key table through
    the streaming mesh engine: engine-dispatched window merges over a
    [B, window] lane stack, skew-aware packing, one COMPACT snapshot.
    Host memory per bucket is about runs x window rows.

    `mesh`: a parallel.bucket_mesh (None: one lane on the table's
    device).  Transient failures are isolated per bucket (module
    docstring, point 4); `retry_policy` overrides the table's
    compaction.retry.* and compaction.mesh.fallback options."""
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.write import CommitMessage
    from paimon_tpu_torch.metrics import (
        COMPACTION_BUCKET_FAILURES, COMPACTION_BUCKET_FALLBACKS,
        COMPACTION_BUCKET_RETRIES, COMPACTION_FALLBACK_MS,
        COMPACTION_WINDOW_MS, global_registry,
    )
    from paimon_tpu_torch.obs import trace as _trace
    from paimon_tpu_torch.obs.trace import span as _obs_span
    from paimon_tpu_torch.ops.merge import SEQ_COL, _pad_size
    from paimon_tpu_torch.ops.ovc import OVC_OFF_SENTINEL, run_ovc_offsets
    from paimon_tpu_torch.parallel.fault import (
        BucketRetryPolicy, is_transient_error,
    )
    from paimon_tpu_torch.parallel.sharded_merge import bucket_mesh

    engine = table.options.merge_engine
    if engine not in SUPPORTED_MERGE_ENGINES:
        raise UnsupportedMergeEngineError(
            f"merge-engine {engine!r} has no mesh compaction merge "
            f"(supported: {', '.join(SUPPORTED_MERGE_ENGINES)})")
    if not table.primary_keys:
        raise ValueError("mesh compaction targets primary-key tables")
    if table.options.changelog_producer != ChangelogProducer.NONE:
        raise ValueError(
            "mesh compaction does not produce changelog; use the "
            "single-chip compaction path for changelog producers")
    if table.options.sequence_field and engine == MergeEngine.FIRST_ROW:
        raise ValueError(
            "sequence.field cannot be used with merge-engine first-row")

    if mesh is None:
        mesh = bucket_mesh(device=table.device)
    _single_process(mesh)
    n_lanes = mesh.n_lanes

    max_level = table.options.max_level
    splits = [s for s in table.new_read_builder().new_scan().plan().splits
              if s.data_files]
    jobs_splits = [s for s in splits if _needs_rewrite(s, max_level)]
    stats = MeshCompactStats(lanes=n_lanes)
    if not jobs_splits:
        return stats

    row_counts = bucket_row_counts(jobs_splits)
    lane_assign = pack_buckets(row_counts, n_lanes)
    stats.buckets = len(jobs_splits)
    stats.input_rows = sum(row_counts)
    stats.lane_rows = [sum(row_counts[i] for i in lane)
                       for lane in lane_assign]
    stats.skew = packing_skew(row_counts, lane_assign)

    ctx = _EngineContext(table)
    lanes_state = [_LaneState([_BucketJob(ctx, jobs_splits[i])
                               for i in lane]) for lane in lane_assign]
    messages: List[CommitMessage] = []

    def finalize(job: _BucketJob) -> None:
        job.flush()
        stats.output_rows += job.out_rows
        stats.peak_buffered_rows = max(
            stats.peak_buffered_rows,
            job.stream_stats.get("peak_buffered_rows", 0))
        messages.append(CommitMessage(
            job.split.partition, job.split.bucket, job.split.total_buckets,
            compact_before=job.files, compact_after=job.metas))

    # -- per-bucket fault isolation (module docstring, point 4) -----------
    _trace.sync_from_options(table.options)
    policy = retry_policy or BucketRetryPolicy.from_options(table.options)
    fault_metrics = global_registry().compaction_metrics()
    attempts: Dict[Tuple, int] = {}
    backoffs: Dict[Tuple, object] = {}

    def _cleanup_job(job: _BucketJob) -> None:
        """Abort a failed attempt: drop buffered output, close the
        window stream, delete the files the attempt already rolled, so
        the retry or fallback starts from the untouched inputs."""
        job.acc, job.acc_bytes = [], 0
        if job._windows is not None:
            try:
                job._windows.close()
            except Exception:               # noqa: BLE001
                stats.cleanup_errors += 1
            job._windows = None
        for m in job.metas:
            for name in [m.file_name, *m.extra_files]:
                path = m.external_path \
                    if (name == m.file_name and m.external_path) \
                    else ctx.path_factory.data_file_path(
                        job.split.partition, job.split.bucket, name)
                try:
                    table.file_io.delete_quietly(path)
                except Exception:           # noqa: BLE001
                    stats.cleanup_errors += 1
        job.metas = []

    def _fallback_single_chip(split) -> Optional[CommitMessage]:
        """Degrade one bucket to the single-chip full rewrite (the same
        merge semantics, 1-D merges on the same device), itself retried
        under the policy."""
        from paimon_tpu_torch.compact.manager import MergeTreeCompactManager

        def run():
            with _obs_span("compaction.fallback", cat="compaction",
                           group="compaction", metric=COMPACTION_FALLBACK_MS,
                           partition=split.partition, bucket=split.bucket,
                           table=table.path):
                return MergeTreeCompactManager(
                    table.file_io, table.path, table.schema, table.options,
                    split.partition, split.bucket, list(split.data_files),
                    schema_manager=table.schema_manager,
                    device=table.device).compact(full=True)

        result = policy.retry_call(run)
        if result is None or result.is_empty():
            return None
        return CommitMessage(
            split.partition, split.bucket, split.total_buckets,
            compact_before=result.before, compact_after=result.after,
            compact_changelog=result.changelog)

    def _handle_bucket_failure(lane_idx: int, job: _BucketJob,
                               exc: BaseException) -> None:
        """Ride the degradation ladder for one bucket; re-raises when
        the error is not transient or the ladder is exhausted."""
        if not is_transient_error(exc):
            raise exc
        lane = lanes_state[lane_idx]
        if lane.current is job:
            lane.current = None
        _cleanup_job(job)
        key = (tuple(job.split.partition), job.split.bucket)
        n = attempts[key] = attempts.get(key, 0) + 1
        if n < max(1, policy.max_attempts):
            stats.retries += 1
            fault_metrics.counter(COMPACTION_BUCKET_RETRIES).inc()
            if key not in backoffs:
                backoffs[key] = policy.new_backoff()
            # a deadline, not a sleep: only this bucket waits out its
            # backoff while the other lanes keep streaming
            retry_job = _BucketJob(ctx, job.split)
            retry_job.ready_at = _time.monotonic() + \
                backoffs[key].next_ms() / 1000.0
            lane.queue.insert(0, retry_job)
            return
        if policy.fallback:
            stats.fallbacks += 1
            fault_metrics.counter(COMPACTION_BUCKET_FALLBACKS).inc()
            try:
                msg = _fallback_single_chip(job.split)
            except Exception:
                fault_metrics.counter(COMPACTION_BUCKET_FAILURES).inc()
                raise
            if msg is not None:
                messages.append(msg)
            return
        fault_metrics.counter(COMPACTION_BUCKET_FAILURES).inc()
        raise exc

    import pyarrow as pa

    kernel = _MeshWindowKernel(mesh, ctx.num_key_lanes, ctx.keep)
    while True:
        step: List[Optional[Tuple]] = []
        for li, lane in enumerate(lanes_state):
            try:
                step.append(lane.next_window(finalize))
            except Exception as e:          # noqa: BLE001
                failed = lane.current
                if failed is None:
                    raise
                _handle_bucket_failure(li, failed, e)
                step.append(None)
        if all(w is None for w in step):
            deadlines = [j.ready_at for lane in lanes_state
                         for j in lane.queue]
            if not deadlines and all(lane.current is None
                                     for lane in lanes_state):
                break
            # every remaining job is inside its backoff: sleep to the
            # earliest deadline (the loop's only wait)
            if deadlines:
                wait = min(deadlines) - _time.monotonic()
                if wait > 0:
                    from paimon_tpu_torch.utils.backoff import wait_for
                    with _obs_span("compaction.backoff_wait",
                                   cat="compaction",
                                   pending=len(deadlines)):
                        wait_for(wait, what="compaction backoff")
            continue
        # each active lane's window; truncated-key windows take the
        # exact host merge instead of the mesh
        device_rows: List[Optional[Tuple]] = [None] * n_lanes
        n_max = 0
        for li, item in enumerate(step):
            if item is None:
                continue
            job, items = item
            try:
                wtable = pa.concat_tables([it[0] for it in items],
                                          promote_options="none") \
                    if len(items) > 1 else items[0][0]
                if wtable.num_rows == 0 or \
                        any(np.asarray(it[2]).any() for it in items):
                    job.emit(ctx.merge_window_host(items))
                    continue
                lanes_mat = np.concatenate([np.asarray(it[1])
                                            for it in items]) \
                    if len(items) > 1 else np.asarray(items[0][1])
                if ctx.seq_fields:
                    from paimon_tpu_torch.ops.merge import (
                        user_seq_order_lanes,
                    )
                    lanes_mat = np.concatenate(
                        [lanes_mat, user_seq_order_lanes(
                            wtable, ctx.seq_fields, ctx.seq_desc)], axis=1)
                seq = np.asarray(wtable.column(SEQ_COL).combine_chunks()
                                 .cast("int64"))
                # each window item is one sorted-run piece: its
                # offset-value codes ride to the device, so the
                # winner-select decides run-consecutive pairs by code
                item_starts = np.concatenate(
                    [[0], np.cumsum([it[0].num_rows
                                     for it in items])]).astype(np.int64)
            except Exception as e:          # noqa: BLE001
                _handle_bucket_failure(li, job, e)
                continue
            device_rows[li] = (job, wtable, lanes_mat, seq, item_starts)
            n_max = max(n_max, wtable.num_rows)
        if n_max == 0:
            continue
        n_pad = _pad_size(n_max)
        lanes_arr = np.zeros((n_lanes, n_pad, ctx.num_lanes),
                             dtype=np.uint32)
        seq_hi = np.zeros((n_lanes, n_pad), dtype=np.uint32)
        seq_lo = np.zeros((n_lanes, n_pad), dtype=np.uint32)
        invalid = np.ones((n_lanes, n_pad), dtype=np.uint32)
        ovc_arr = np.full((n_lanes, n_pad), OVC_OFF_SENTINEL,
                          dtype=np.uint32)
        for li, entry in enumerate(device_rows):
            if entry is None:
                continue
            _, wtable, lanes_mat, seq, item_starts = entry
            k = wtable.num_rows
            lanes_arr[li, :k] = lanes_mat
            u = seq.astype(np.int64).view(np.uint64)
            seq_hi[li, :k] = (u >> np.uint64(32)).astype(np.uint32)
            seq_lo[li, :k] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            invalid[li, :k] = 0
            ovc_arr[li, :k] = run_ovc_offsets(lanes_arr[li, :k],
                                              item_starts)
        try:
            with _obs_span("compaction.window", cat="compaction",
                           group="compaction", metric=COMPACTION_WINDOW_MS,
                           lanes=sum(1 for e in device_rows
                                     if e is not None),
                           rows=n_max, table=table.path):
                perm, winner, _ = kernel(lanes_arr, seq_hi, seq_lo,
                                         invalid, ovc_arr)
        except Exception as e:              # noqa: BLE001
            # a failed window merge is a lane or device failure for every
            # bucket in flight this step: each rides its own ladder
            for li, entry in enumerate(device_rows):
                if entry is not None:
                    _handle_bucket_failure(li, entry[0], e)
            continue
        for li, entry in enumerate(device_rows):
            if entry is None:
                continue
            job, wtable = entry[0], entry[1]
            try:
                job.emit(ctx.merge_window_device(wtable, perm[li],
                                                 winner[li]))
            except Exception as e:          # noqa: BLE001
                _handle_bucket_failure(li, job, e)
                continue
            stats.windows += 1
            stats.peak_window_rows = max(stats.peak_window_rows,
                                         wtable.num_rows)

    if messages:
        commit = FileStoreCommit(table.file_io, table.path, table.schema,
                                 table.options, branch=table.branch)
        stats.snapshot_id = commit.commit(messages)
    _trace.maybe_export()
    return stats
