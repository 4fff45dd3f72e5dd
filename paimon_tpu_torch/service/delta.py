"""Hot in-memory delta tier: serve unflushed writes at once.

Counterpart of paimon_tpu/service/delta.py.  The LSM advances only at
flush + commit, so a freshly written key is otherwise invisible until a
commit lands.  A serving writer's rows enter a small in-memory index as
they are written (core/write.py's delta listener), and every point
lookup (lookup/local_query.py) probes it first, newest first, with the
LSM's tombstone and sequence semantics.

* The tier holds generations: the open one receives writes; a commit
  seals it with its snapshot id.  Sealed generations retire only once
  every attached reader's plan covers that snapshot.
* A lookup batch captures an immutable view before its plan, so the
  plan covers whatever the view lost.
* Eligibility is the LSM fast path's: deduplicate, no sequence.field,
  no record-level expire, fixed buckets.  One serving writer per table.
* service.delta.max-bytes is a soft bound (counted as delta_overflow):
  an acknowledged write is never dropped.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.types import RowKind

__all__ = ["DeltaTier", "DeltaView", "ServingWriter",
           "delta_eligible", "delta_ineligible_reason",
           "shared_delta_tier", "reset_delta_tiers"]

_MISS = object()          # probe sentinel: key not in the delta


def delta_ineligible_reason(table) -> Optional[str]:
    """Why this table cannot ride the delta tier (None = eligible).
    The gate mirrors LocalTableQuery._fast_path_ok plus the write-side
    configurations that defer or re-route rows."""
    from paimon_tpu_torch.options import CoreOptions, MergeEngine
    opts = table.options
    if not table.primary_keys:
        return "delta tier requires a primary-key table"
    if opts.merge_engine != MergeEngine.DEDUPLICATE:
        return (f"delta tier requires deduplicate merge semantics "
                f"(merge-engine={opts.merge_engine})")
    if opts.sequence_field:
        return "sequence.field orders rows by value, not write time"
    if opts.record_level_expire_time_ms:
        return "record-level expire changes visibility over time"
    if opts.get(CoreOptions.DELETION_VECTORS_ENABLED):
        return "deletion-vectors maintenance rewrites row visibility"
    if opts.bucket < 1:
        return (f"delta tier requires fixed buckets "
                f"(bucket={opts.bucket})")
    if table.schema.cross_partition_update():
        return "cross-partition upsert re-routes rows at flush time"
    if opts.get(CoreOptions.LOCAL_MERGE_BUFFER_SIZE):
        return "local-merge buffers rows past the write() hook"
    return None


def delta_eligible(table) -> bool:
    return delta_ineligible_reason(table) is None


# -- process-wide tier registry (replicas + the serving writer over one
#    table must see ONE tier) ------------------------------------------------

_TIERS: Dict[str, "DeltaTier"] = {}
_TIERS_LOCK = threading.Lock()


def shared_delta_tier(table) -> "DeltaTier":
    """One DeltaTier per table path per process: every in-process
    replica server and the serving writer share it (the cross-replica
    analog of fs/caching.shared_cache_state)."""
    key = str(table.path)
    with _TIERS_LOCK:
        tier = _TIERS.get(key)
        if tier is None:
            tier = DeltaTier(table)
            _TIERS[key] = tier
        return tier


def reset_delta_tiers():
    """Test hook: drop every registered tier."""
    with _TIERS_LOCK:
        _TIERS.clear()


class DeltaView:
    """Immutable capture of the tier for ONE lookup batch: the open
    generation ref plus the sealed list ref at capture time.  Pruning
    replaces lists, never mutates them, so a captured view keeps its
    generations alive for the whole batch."""

    __slots__ = ("_gens",)

    def __init__(self, gens: Tuple[dict, ...]):
        self._gens = gens          # newest first

    @property
    def empty(self) -> bool:
        return not any(self._gens)

    def touches(self, pkey: str, buckets) -> bool:
        """Whether ANY of the batch's (pkey, bucket) groups exists in
        any generation — the cheap gate before a lookup batch pays
        for per-key materialization and probing."""
        for gen in self._gens:
            if not gen:
                continue
            for b in buckets:
                if (pkey, b) in gen:
                    return True
        return False

    def probe(self, pkey: str, bucket: int, key_tuple: Tuple):
        """Newest delta entry for the key: the stored row dict, None
        for a tombstone, or the _MISS sentinel (fall through to the
        LSM walk)."""
        gkey = (pkey, bucket)
        for gen in self._gens:
            m = gen.get(gkey)
            if m is None:
                continue
            hit = m.get(key_tuple)
            if hit is None:
                continue
            _seq, kind, row = hit
            if kind in (RowKind.DELETE, RowKind.UPDATE_BEFORE):
                return None        # tombstone: the key is deleted
            return row
        return _MISS

    @staticmethod
    def is_miss(result) -> bool:
        return result is _MISS


class DeltaTier:
    """The shared per-table delta index (see module docstring)."""

    def __init__(self, table):
        from paimon_tpu_torch.metrics import (
            SERVICE_DELTA_BYTES, SERVICE_DELTA_OVERFLOWS,
            SERVICE_DELTA_ROWS, global_registry,
        )
        from paimon_tpu_torch.options import CoreOptions
        self.pk = table.schema.trimmed_primary_keys()
        self.max_bytes = table.options.get(
            CoreOptions.SERVICE_DELTA_MAX_BYTES)
        self._lock = threading.Lock()
        # open generation: {(pkey, bucket): {key_tuple: (seq, kind,
        # row)}}; sealed: ((snapshot_id, gen, rows, bytes), ...)
        # oldest first — both REPLACED, never mutated, on seal/prune
        self._open: dict = {}
        self._open_rows = 0
        self._open_bytes = 0
        self._sealed: Tuple[Tuple[int, dict, int, int], ...] = ()
        # reader -> last served plan snapshot (None = never loaded);
        # pruning floors on the min over loaded readers
        self._readers: Dict[int, Tuple[object, Optional[int]]] = {}
        g = global_registry().service_metrics(table.name)
        self._g_rows = g.gauge(SERVICE_DELTA_ROWS)
        self._g_bytes = g.gauge(SERVICE_DELTA_BYTES)
        self._m_overflow = g.counter(SERVICE_DELTA_OVERFLOWS)

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            rows = self._open_rows + sum(s[2] for s in self._sealed)
            nbytes = self._open_bytes + sum(s[3] for s in self._sealed)
            return {"rows": rows, "bytes": nbytes,
                    "open_rows": self._open_rows,
                    "sealed_generations": len(self._sealed),
                    "max_bytes": self.max_bytes}

    def _set_gauges_locked(self):
        self._g_rows.set(self._open_rows
                         + sum(s[2] for s in self._sealed))
        self._g_bytes.set(self._open_bytes
                          + sum(s[3] for s in self._sealed))

    # -- write side (the core/write.py delta_listener hook) ------------------

    @staticmethod
    def _pkey(partition: Tuple) -> str:
        # MUST match LocalTableQuery._pkey: the probe keys by the same
        # composite string
        return json.dumps([repr(v) for v in tuple(partition)])

    def on_write(self, partition: Tuple, bucket: int, table, kinds,
                 seqs):
        """Publish one written batch into the open generation (called
        from _BucketWriter.write on the single-threaded writer, AFTER
        sequence reservation — so seq order here is write order)."""
        rows = table.to_pylist()
        pkey = self._pkey(partition)
        per_row = max(64, table.nbytes // max(1, table.num_rows))
        with self._lock:
            bucket_map = self._open.setdefault((pkey, int(bucket)), {})
            for row, kind, seq in zip(rows, kinds, seqs):
                kt = tuple(row[k] for k in self.pk)
                prev = bucket_map.get(kt)
                if prev is None:
                    self._open_rows += 1
                    self._open_bytes += per_row
                elif prev[0] > seq:
                    continue       # an even newer write already landed
                bucket_map[kt] = (int(seq), int(kind), row)
            if self._open_bytes + sum(s[3] for s in self._sealed) \
                    > self.max_bytes:
                self._m_overflow.inc()
            self._set_gauges_locked()

    def seal(self, snapshot_id: int):
        """The open generation's rows are durably committed as
        `snapshot_id`: move it to the sealed list (the dict object
        itself — a concurrent batch's captured view keeps serving it)
        and open a fresh one.  Prunes what the readers allow."""
        with self._lock:
            if self._open:
                self._sealed = self._sealed + (
                    (int(snapshot_id), self._open, self._open_rows,
                     self._open_bytes),)
                self._open = {}
                self._open_rows = 0
                self._open_bytes = 0
            self._prune_locked()
            self._set_gauges_locked()

    def discard_open(self):
        """Abandoned serving writer: its uncommitted rows must stop
        being served (they were never durably published — exactly like
        dropping an uncommitted write buffer)."""
        with self._lock:
            self._open = {}
            self._open_rows = 0
            self._open_bytes = 0
            self._set_gauges_locked()

    # -- read side -----------------------------------------------------------

    def view(self) -> DeltaView:
        """Capture for one lookup batch.  Callers MUST capture the
        view BEFORE capturing their plan: view-then-plan means every
        generation the plan does not cover is still in the view (the
        reverse order could miss a generation pruned between the plan
        capture and the view capture)."""
        with self._lock:
            gens: List[dict] = [self._open]
            for _sid, gen, _r, _b in reversed(self._sealed):
                gens.append(gen)
            return DeltaView(tuple(gens))

    def register_reader(self, reader):
        with self._lock:
            self._readers[id(reader)] = (reader, None)

    def unregister_reader(self, reader):
        with self._lock:
            self._readers.pop(id(reader), None)
            self._prune_locked()
            self._set_gauges_locked()

    def reader_advanced(self, reader, snapshot_id: Optional[int]):
        """A reader installed a plan at `snapshot_id`; sealed
        generations at or below the MIN across all loaded readers are
        covered by every plan and can retire."""
        with self._lock:
            if id(reader) in self._readers:
                self._readers[id(reader)] = (reader, snapshot_id)
            self._prune_locked()
            self._set_gauges_locked()

    def _prune_locked(self):
        if not self._sealed:
            return
        if not self._readers:
            # nobody can serve the delta: retire everything (a reader
            # registering LATER loads the latest snapshot, which
            # covers every sealed generation — their commits
            # completed before seal)
            self._sealed = ()
            return
        floors = [sid for _r, sid in self._readers.values()]
        if any(sid is None for sid in floors):
            # a registered reader has not loaded (or is MID-first-load
            # having already sampled an older snapshot id): its floor
            # is unknown — pruning now could un-publish rows its
            # about-to-install plan does not cover.  Keep everything
            # until it reports in (readers unregister on close, so
            # this cannot pin generations forever)
            return
        floor = min(floors)
        self._sealed = tuple(s for s in self._sealed if s[0] > floor)


class ServingWriter:
    """A TableWrite + TableCommit pair wired into the delta tier: every
    written row is readable via the serving plane's /lookup BEFORE any
    flush or commit, and `commit()` seals the generation with the
    published snapshot id so it retires once every replica's plan
    covers it.

        sw = server.new_serving_writer()
        sw.write_dicts([{"id": 7, "v": 1.5}])   # readable NOW
        sw.commit()                             # durable; delta retires

    One serving writer per table (see module docstring)."""

    def __init__(self, table, delta: DeltaTier,
                 commit_user: Optional[str] = None):
        reason = delta_ineligible_reason(table)
        if reason is not None:
            raise ValueError(f"table not delta-eligible: {reason}")
        self.table = table
        self.delta = delta
        if commit_user:
            wb = table.new_stream_write_builder() \
                .with_commit_user(commit_user)
        else:
            wb = table.new_batch_write_builder()
        self._builder = wb
        self._write = wb.new_write()
        self._write.set_delta_listener(delta.on_write)
        self._commit = wb.new_commit()
        self._closed = False

    # -- writes (delegate; the delta listener fires inside) ------------------

    def write_arrow(self, data, row_kinds=None):
        self._write.write_arrow(data, row_kinds)

    def write_dicts(self, rows, row_kinds=None):
        self._write.write_dicts(rows, row_kinds)

    def commit(self, commit_identifier: Optional[int] = None,
               properties: Optional[dict] = None) -> Optional[int]:
        """Flush + commit + seal: after this returns, the generation's
        rows are durable AND still served from the delta until every
        attached reader's plan covers the new snapshot — there is no
        visibility gap at the handoff."""
        msgs = self._write.prepare_commit()
        kwargs = {}
        if commit_identifier is not None:
            kwargs["commit_identifier"] = commit_identifier
        if properties is not None:
            kwargs["properties"] = properties
        sid = self._commit.commit(msgs, **kwargs)
        if sid is not None:
            self.delta.seal(sid)
        return sid

    def close(self):
        """Close the writer; uncommitted (never-sealed) rows stop
        being served — an abandoned open generation must not outlive
        the writer that could have committed it."""
        if self._closed:
            return
        self._closed = True
        try:
            self._write.close()
        finally:
            self.delta.discard_open()

    def __enter__(self) -> "ServingWriter":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
