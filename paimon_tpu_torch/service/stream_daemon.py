"""Streaming lakehouse daemon: checkpointed exactly-once CDC ingest,
level-triggered compaction and changelog serving over ONE table, as
three supervised concurrent loops.

Counterpart of paimon_tpu/service/stream_daemon.py in its single-host
mode, the long-running form of Paimon's core scenario: continuous
upserts into per-bucket LSM trees with low-latency streaming changelog
reads, built from the batch pieces of the port:

    ingest   cdc/sink.py + parallel/write_pipeline.py (flush budget =
             backpressure), offsets committed ATOMICALLY with each
             snapshot via commit properties
    compact  table.compact (full compactions through the mesh engine
             when tpu.mesh.compact is set), manifest compaction and
             snapshot expiry
    serve    table/stream_scan.py follow-up scans, buffered for
             in-process consumers; the query service's `/changelog`
             serves the same table to remote ones

Every merge of the three loops runs on the table's device: the daemon
takes its device from its table and never chooses one itself, and a
supervised restart reloads the table on that same device.

Robustness model
----------------

**Exactly-once ingest.**  A checkpoint is one snapshot committed with
`commit_identifier = N` and properties::

    stream.source.offset  offset of the last CDC event included
    stream.ingest.ts-ms   wall time the checkpoint's first event was
                          pulled (feeds end-to-end freshness)

Recovery (daemon start OR supervised ingest-loop restart) discards the
writer (uploaded-but-uncommitted files become orphans for maintenance),
reads the newest snapshot of this daemon's commit user that carries an
offset, and re-polls the source after it.  Replay is idempotent twice
over: the source offset only advances inside committed snapshots, and
`CdcSinkWriter.commit` + `filter_committed` drop a checkpoint whose
CAS landed but whose ack was lost (cdc/sink.py).

**Backpressure.**  The ingest loop pulls at most
`stream.ingest.max-batch` events per poll and hands them straight to
the writer, whose `write.flush.max-bytes` budget BLOCKS the loop while
the flush pipeline is saturated; the daemon holds no internal event
queue.  The changelog buffer is bounded (`stream.serve.buffer.rows`): a
lagging consumer stalls the serving loop, never memory.

**Supervision.**  Each loop runs under a supervisor that restarts it on
any error with capped decorrelated-jitter backoff (utils/backoff.py,
`stream.restart.*`); a run longer than `stream.restart.healthy-
threshold` resets the schedule.  A loop past
`stream.restart.max-restarts` consecutive unhealthy restarts dies for
good: its status says `failed`, and it leaves a flight dump and a trace
spool flush behind.  Compaction pauses while ingest is under pressure
(`stream.compaction.pause-*`), and serving keeps reading committed
snapshots while ingest or compaction are down.

**Drain.**  `stop()` (also wired to SIGTERM/SIGINT via
`install_signal_handlers`) stops pulling, commits one final checkpoint
for everything already ingested, lets the serving loop catch up to the
final snapshot, then joins all loops.  `kill()` is the crash path:
loops abandon work immediately and nothing past the last committed
checkpoint survives.

The reference's distributed mode (`plane=`, one logical daemon over
several hosts with takeover and rejoin) needs parallel/maintenance_plane.py
and is not ported yet (ROADMAP.md A.8.9): `plane=` raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.table.table import FileStoreTable

__all__ = ["StreamDaemon", "recover_checkpoint", "checkpoint_once",
           "recover_max_identifier", "recover_plane_stamps",
           "find_checkpoint_snapshot", "PROP_OFFSET", "PROP_INGEST_TS"]

PROP_OFFSET = "stream.source.offset"
PROP_INGEST_TS = "stream.ingest.ts-ms"

DEFAULT_COMMIT_USER = "stream-daemon"


def _now_ms() -> int:
    return int(time.time() * 1000)


def _plane_not_ported(what: str):
    raise NotImplementedError(
        f"{what} needs parallel/maintenance_plane.py and "
        f"parallel/distributed.py, which are not ported to "
        f"paimon_tpu_torch yet (ROADMAP.md: A.8.9)")


def _rows(table) -> List[dict]:
    """`table.to_pylist()`: numeric and boolean columns without nulls
    convert through numpy (the same Python ints, floats and bools), the
    others value by value."""
    import pyarrow as pa

    cols = []
    for col in table.columns:
        t = col.type
        if col.null_count == 0 and (pa.types.is_integer(t) or
                                    pa.types.is_floating(t) or
                                    pa.types.is_boolean(t)):
            cols.append(col.to_numpy().tolist())
        else:
            cols.append(col.to_pylist())
    names = table.column_names
    return [dict(zip(names, vals)) for vals in zip(*cols)]


def find_checkpoint_snapshot(table: FileStoreTable, commit_user: str):
    """Newest snapshot of `commit_user` carrying an offset property,
    or None."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    earliest = sm.earliest_snapshot_id()
    if latest is None or earliest is None:
        return None
    for sid in range(latest, earliest - 1, -1):
        try:
            snap = sm.snapshot(sid)
        except FileNotFoundError:
            continue              # expired under us
        if snap.commit_user != commit_user:
            continue
        if PROP_OFFSET in (snap.properties or {}):
            return snap
    return None


def recover_checkpoint(table: FileStoreTable,
                       commit_user: str) -> tuple:
    """(last committed source offset, last commit identifier) for this
    daemon user, from the newest snapshot carrying an offset property;
    (-1, 0) when the daemon has never checkpointed.  The offset is read
    from snapshot properties, so it is exactly as durable as the data
    it describes."""
    snap = find_checkpoint_snapshot(table, commit_user)
    if snap is None:
        return -1, 0
    return int(snap.properties[PROP_OFFSET]), snap.commit_identifier


def recover_max_identifier(table: FileStoreTable,
                           commit_user: str) -> int:
    """Largest non-batch commit identifier this user ever committed."""
    from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER
    best = 0
    for snap in table.snapshot_manager.snapshots():
        if snap.commit_user != commit_user:
            continue
        if snap.commit_identifier == BATCH_COMMIT_IDENTIFIER:
            continue
        best = max(best, snap.commit_identifier)
    return best


def recover_plane_stamps(table: FileStoreTable, commit_user: str):
    """The distributed daemon's adoption ledger and offset floors."""
    _plane_not_ported("recover_plane_stamps")


def checkpoint_once(table: FileStoreTable, source, *,
                    commit_user: str = DEFAULT_COMMIT_USER,
                    format: str = "debezium",
                    max_events: Optional[int] = None) -> Optional[int]:
    """One synchronous ingest step: recover the committed offset, pull
    every available event past it (up to `max_events`) and commit ONE
    checkpoint.  This is the daemon's ingest loop unrolled, and the
    crash-sweep surface of the offset-commit path: killing any mutating
    op inside it must leave a table that recovers to exactly one copy
    of every event."""
    from paimon_tpu_torch.cdc.sink import CdcSinkWriter

    offset, last_ckpt = recover_checkpoint(table, commit_user)
    events = source.poll(offset, max_events if max_events is not None
                         else 1 << 30)
    if not events:
        return None
    ingest_ts = _now_ms()
    sink = CdcSinkWriter(table.copy({"write-only": "true"}),
                         format=format, commit_user=commit_user)
    try:
        sink.write_events([e for _, e in events])
        return sink.commit(
            last_ckpt + 1,
            properties={PROP_OFFSET: str(events[-1][0]),
                        PROP_INGEST_TS: str(ingest_ts)})
    finally:
        sink.close()


class _Supervisor:
    """Runs one loop body in a named thread, restarting it on failure
    with capped decorrelated-jitter backoff.  The body is expected to
    loop until the daemon stops and return; any raise is a crash."""

    def __init__(self, daemon: "StreamDaemon", name: str, body):
        self.daemon = daemon
        self.name = name
        self.body = body
        self.restarts = 0
        self.consecutive = 0
        self.last_error: Optional[str] = None
        self.failed = False
        self.thread: Optional[threading.Thread] = None

    def start(self):
        from paimon_tpu_torch.parallel.executors import spawn_thread
        self.thread = spawn_thread(self._run,
                                   name=f"paimon-stream-{self.name}")

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def join(self, timeout: Optional[float]):
        if self.thread is not None:
            self.thread.join(timeout)

    def _run(self):
        from paimon_tpu_torch.metrics import STREAM_LOOP_RESTARTS
        from paimon_tpu_torch.obs.trace import span
        from paimon_tpu_torch.utils.backoff import Backoff

        d = self.daemon
        backoff: Optional[Backoff] = None
        while not d._stop.is_set():
            t0 = time.monotonic()
            try:
                self.body()
                return                        # clean exit (stop/drain)
            except BaseException as e:        # noqa: BLE001 — supervised
                self.last_error = f"{type(e).__name__}: {e}"
                if d._killed:
                    return                    # crash path: expected
                if d._stop.is_set():
                    # crashed DURING drain (the final checkpoint commit
                    # failed): no restart is coming, so surface it
                    self.failed = True
                    self._record_terminal("drain")
                    return
                self.restarts += 1
                d._metrics.counter(STREAM_LOOP_RESTARTS).inc()
                healthy = (time.monotonic() - t0) * 1000 >= \
                    d._o["healthy_ms"]
                self.consecutive = 0 if healthy else self.consecutive + 1
                if d._o["max_restarts"] is not None and \
                        self.consecutive > d._o["max_restarts"]:
                    self.failed = True
                    self._record_terminal("max_restarts")
                    return                    # terminal; status carries it
                if healthy or backoff is None:
                    backoff = Backoff(d._o["restart_backoff_ms"],
                                      d._o["restart_cap_ms"])
                wait_ms = backoff.next_ms()
                with span("stream.restart.backoff", cat="stream",
                          loop=self.name, attempt=self.restarts,
                          error=type(e).__name__):
                    d._stop.wait(wait_ms / 1000.0)

    def _record_terminal(self, why: str):
        """A loop died for good: black-box the crash so a post-mortem
        sees the triggering event and the ring before it."""
        from paimon_tpu_torch.obs import flight
        from paimon_tpu_torch.obs.trace import spool_flush
        flight.record(flight.EV_LOOP_CRASH, loop=self.name, why=why,
                      error=self.last_error, restarts=self.restarts)
        flight.dump()
        spool_flush()


class StreamDaemon:
    """Drive ingest + compaction + changelog serving over one table, on
    the table's device.

    Usage::

        daemon = StreamDaemon(table, source).start()
        ...
        rows = daemon.poll_changelog(max_rows=1000)
        ...
        daemon.stop()          # drain: final checkpoint, serve catches up
    """

    def __init__(self, table: FileStoreTable, source, *,
                 format: str = "debezium",
                 commit_user: str = DEFAULT_COMMIT_USER,
                 compact: bool = True, serve: bool = True,
                 dynamic_options: Optional[Dict[str, str]] = None,
                 plane=None):
        from paimon_tpu_torch.metrics import global_registry
        from paimon_tpu_torch.obs import flight
        from paimon_tpu_torch.obs.trace import sync_from_options

        if plane is not None:
            _plane_not_ported("a distributed stream daemon (plane=)")
        self._dynamic = dict(dynamic_options or {})
        self.table = table.copy(self._dynamic) if self._dynamic else table
        self.device = self.table.device
        self.source = source
        self.format = format
        self.plane = None
        self.commit_user = commit_user
        o = self.table.options
        sync_from_options(o)
        flight.sync_from_options(o)
        self._o = {
            "ckpt_interval_ms": o.get(
                CoreOptions.STREAM_CHECKPOINT_INTERVAL),
            "max_batch": o.get(CoreOptions.STREAM_INGEST_MAX_BATCH),
            "ingest_poll_ms": o.get(
                CoreOptions.STREAM_INGEST_POLL_INTERVAL),
            "compact_interval_ms": o.get(
                CoreOptions.STREAM_COMPACTION_INTERVAL),
            "compact_full": o.get(CoreOptions.STREAM_COMPACTION_FULL),
            "manifest_compact_interval_ms": o.get(
                CoreOptions.STREAM_MANIFEST_COMPACTION_INTERVAL),
            "pause_ratio": o.get(
                CoreOptions.STREAM_COMPACTION_PAUSE_RATIO),
            "pause_backlog": o.get(
                CoreOptions.STREAM_COMPACTION_PAUSE_BACKLOG),
            "serve_poll_ms": o.get(
                CoreOptions.STREAM_SERVE_POLL_INTERVAL),
            "serve_buffer_rows": o.get(
                CoreOptions.STREAM_SERVE_BUFFER_ROWS),
            "restart_backoff_ms": o.get(
                CoreOptions.STREAM_RESTART_BACKOFF),
            "restart_cap_ms": o.get(
                CoreOptions.STREAM_RESTART_BACKOFF_CAP),
            "healthy_ms": o.get(CoreOptions.STREAM_RESTART_HEALTHY_MS),
            "max_restarts": o.get(CoreOptions.STREAM_RESTART_MAX),
            "expire_interval_ms": o.get(
                CoreOptions.STREAM_EXPIRE_INTERVAL),
            "flush_max_bytes": o.get(CoreOptions.WRITE_FLUSH_MAX_BYTES),
        }
        self._metrics = global_registry().stream_metrics()
        self._stop = threading.Event()
        self._draining = False
        self._killed = False
        self._signal = threading.Event()
        self._last_close_error: Optional[str] = None

        # ingest state (owned by the ingest thread; exposed read-only)
        self._sink = None
        self._offset = -1              # last COMMITTED source offset
        self._offset_pending = -1      # last offset written to the sink
        self._next_ckpt = 1
        self._batch_first_pull_ms: Optional[int] = None

        # bounded changelog buffer (serve loop -> consumers)
        self._buf: List[dict] = []
        self._buf_cond = threading.Condition()

        self._loops: List[_Supervisor] = [
            _Supervisor(self, "ingest", self._ingest_body)]
        if compact:
            self._loops.append(
                _Supervisor(self, "compact", self._compact_body))
        if serve:
            self._loops.append(
                _Supervisor(self, "serve", self._serve_body))

    def _load(self, extra: Optional[Dict[str, str]] = None
              ) -> FileStoreTable:
        """The table as committed now, on the daemon's device."""
        dynamic = {**self._dynamic, **(extra or {})}
        return FileStoreTable.load(
            self.table.path, file_io=self.table.file_io,
            dynamic_options=dynamic or None, device=self.device)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StreamDaemon":
        for sup in self._loops:
            sup.start()
        return self

    def stop(self, drain: bool = True,
             timeout: float = 30.0) -> Dict:
        """Stop the daemon.  With `drain` (the default) the ingest loop
        commits a final checkpoint for everything already pulled and
        the serving loop catches up to the final snapshot before
        exiting; without it this behaves like `kill()`."""
        if not drain:
            return self.kill()
        self._draining = True
        self._stop.set()
        with self._buf_cond:
            self._buf_cond.notify_all()
        deadline = time.monotonic() + timeout
        # join ingest FIRST (it commits the final checkpoint), serve
        # second (it must still be running to see that final snapshot)
        for name in ("ingest", "compact", "serve"):
            for sup in self._loops:
                if sup.name == name:
                    sup.join(max(0.1, deadline - time.monotonic()))
        if any(sup.alive() for sup in self._loops):
            # a loop is wedged (a consumer stopped draining the
            # changelog buffer): force the crash path for what remains
            self._killed = True
            with self._buf_cond:
                self._buf_cond.notify_all()
            for sup in self._loops:
                sup.join(5.0)
        self._close_sink()
        from paimon_tpu_torch.obs.trace import maybe_export
        maybe_export()
        return self.status()

    def kill(self) -> Dict:
        """Abrupt termination (the crash path): no final checkpoint, no
        serve catch-up.  Everything since the last committed checkpoint
        is lost; a new daemon on the same table + source replays it
        exactly once."""
        self._killed = True
        self._stop.set()
        with self._buf_cond:
            self._buf_cond.notify_all()
        for sup in self._loops:
            sup.join(10.0)
        self._close_sink()
        from paimon_tpu_torch.obs.trace import spool_flush
        spool_flush()
        return self.status()

    def install_signal_handlers(self):
        """SIGTERM/SIGINT -> graceful drain (run_forever returns).

        The handler flushes the trace spool and the flight ring before
        the drain starts: if the drain wedges and the process is then
        killed hard, the black box still made it to disk."""
        import signal

        def handler(signum, frame):
            from paimon_tpu_torch.obs import flight
            from paimon_tpu_torch.obs.trace import spool_flush
            flight.record(flight.EV_SIGTERM, signum=signum)
            flight.dump()
            spool_flush()
            self._signal.set()

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass     # not the main thread: caller drives stop() itself

    def run_forever(self, duration_s: Optional[float] = None) -> Dict:
        """Block until SIGTERM/SIGINT (or `duration_s`), then drain."""
        self._signal.wait(duration_s)
        return self.stop(drain=True)

    def status(self) -> Dict:
        return {
            "commit_user": self.commit_user,
            "offset_committed": self._offset,
            "offset_pending": self._offset_pending,
            "next_checkpoint": self._next_ckpt,
            "draining": self._draining,
            "killed": self._killed,
            "buffered_rows": len(self._buf),
            "sink_close_error": self._last_close_error,
            "loops": {
                sup.name: {"alive": sup.alive(),
                           "restarts": sup.restarts,
                           "failed": sup.failed,
                           "last_error": sup.last_error}
                for sup in self._loops},
        }

    # -- changelog consumption ----------------------------------------------

    def poll_changelog(self, max_rows: int = 4096,
                       timeout: Optional[float] = None) -> List[dict]:
        """Pop up to `max_rows` buffered changelog rows (each carries
        `_ROW_KIND`); blocks up to `timeout` for the first row."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._buf_cond:
            while not self._buf:
                if self._stop.is_set() and not self._serve_alive():
                    return []
                wait = 0.2 if deadline is None \
                    else min(0.2, deadline - time.monotonic())
                if wait <= 0:
                    return []
                self._buf_cond.wait(wait)
            out = self._buf[:max_rows]
            del self._buf[:max_rows]
            self._buf_cond.notify_all()
            return out

    def _serve_alive(self) -> bool:
        return any(sup.name == "serve" and sup.alive()
                   for sup in self._loops)

    def _ingest_alive(self) -> bool:
        return any(sup.name == "ingest" and sup.alive()
                   for sup in self._loops)

    # -- ingest loop ---------------------------------------------------------

    def _ingest_recover(self):
        """(Re)entry of the ingest loop = recovery: drop the writer
        (its uncommitted uploads become orphans), reload the table
        (the schema may have evolved), re-read the committed offset."""
        from paimon_tpu_torch.cdc.sink import CdcSinkWriter

        self._close_sink()
        table = self._load({"write-only": "true"})
        offset, last_ckpt = recover_checkpoint(table, self.commit_user)
        # in-memory floor: on a supervised IN-PROCESS restart, never
        # fall behind what this process already saw committed (an
        # expired offset snapshot must not re-ingest committed events
        # or reuse identifiers)
        self._offset = max(offset, self._offset)
        self._offset_pending = self._offset
        self._next_ckpt = max(last_ckpt + 1, self._next_ckpt)
        self._batch_first_pull_ms = None
        self._sink = CdcSinkWriter(table, format=self.format,
                                   commit_user=self.commit_user)

    def _close_sink(self):
        if self._sink is None:
            return
        try:
            self._sink.close()
        except Exception as e:                # noqa: BLE001
            # close() joins the flush pool, which can re-raise a latched
            # worker error; the sink is discarded either way: record it
            # and let the recovery that follows run
            self._metrics.counter("sink_close_errors").inc()
            self._last_close_error = f"{type(e).__name__}: {e}"
        self._sink = None

    def _ingest_body(self):
        from paimon_tpu_torch.metrics import (
            STREAM_EVENTS_INGESTED, STREAM_SOURCE_BACKLOG,
        )
        from paimon_tpu_torch.obs.trace import span

        self._ingest_recover()
        o = self._o
        last_ckpt_at = time.monotonic()
        while True:
            if self._killed:
                return
            stopping = self._stop.is_set()
            events = [] if stopping else self.source.poll(
                self._offset_pending, o["max_batch"])
            now_mono = time.monotonic()
            if events:
                if self._batch_first_pull_ms is None:
                    self._batch_first_pull_ms = _now_ms()
                with span("stream.ingest.batch", cat="stream",
                          events=len(events), owned=len(events),
                          first=events[0][0], last=events[-1][0]):
                    # write_events blocks on write.flush.max-bytes: the
                    # backpressure coupling, no internal queue
                    self._sink.write_events([e for _, e in events])
                self._offset_pending = events[-1][0]
                self._metrics.counter(STREAM_EVENTS_INGESTED) \
                    .inc(len(events))
            self._metrics.gauge(STREAM_SOURCE_BACKLOG).set(
                self.source.backlog(self._offset_pending))
            pending = self._offset_pending > self._offset
            if pending and (stopping or
                            (now_mono - last_ckpt_at) * 1000
                            >= o["ckpt_interval_ms"]):
                self._checkpoint()
                last_ckpt_at = time.monotonic()
            if stopping:
                return            # drained (final checkpoint above)
            if not events:
                self._stop.wait(o["ingest_poll_ms"] / 1000.0)

    def _checkpoint(self):
        from paimon_tpu_torch.metrics import (
            STREAM_CHECKPOINT_MS, STREAM_CHECKPOINTS,
        )
        from paimon_tpu_torch.obs.trace import span

        ckpt = self._next_ckpt
        props = {PROP_OFFSET: str(self._offset_pending),
                 PROP_INGEST_TS: str(self._batch_first_pull_ms
                                     or _now_ms())}
        with span("stream.checkpoint", cat="stream", group="stream",
                  metric=STREAM_CHECKPOINT_MS, checkpoint=ckpt,
                  offset=self._offset_pending):
            self._sink.commit(ckpt, properties=props)
        # past this line the checkpoint is durable: advance in-memory
        # state (a crash between commit and here replays the
        # checkpoint, which filter_committed + pending-keying dedup)
        self._offset = self._offset_pending
        self._next_ckpt = ckpt + 1
        self._batch_first_pull_ms = None
        self._metrics.counter(STREAM_CHECKPOINTS).inc()
        # sources that cache events may evict everything at or below
        # the now-durable offset (FileCdcSource bounds its memory so)
        commit_through = getattr(self.source, "commit_through", None)
        if commit_through is not None:
            commit_through(self._offset)

    # -- compaction loop -----------------------------------------------------

    def _ingest_pressure(self) -> bool:
        from paimon_tpu_torch.metrics import (
            STREAM_SOURCE_BACKLOG, WRITE_INFLIGHT_BYTES, global_registry,
        )

        inflight = global_registry().write_metrics() \
            .gauge(WRITE_INFLIGHT_BYTES).value
        budget = self._o["flush_max_bytes"]
        if budget and inflight > self._o["pause_ratio"] * budget:
            return True
        backlog = self._metrics.gauge(STREAM_SOURCE_BACKLOG).value
        return backlog > self._o["pause_backlog"]

    def _needs_compaction(self, table: FileStoreTable) -> bool:
        """Level/size trigger: any bucket at or over the sorted-run
        trigger (primary-key tables: each level-0 file counts as a run,
        each higher level as one, compact/levels.py's reading) or, for
        append tables, at or over compaction.min.file-num."""
        snapshot = table.latest_snapshot()
        if snapshot is None:
            return False
        scan = table.new_scan()
        per_bucket: Dict[tuple, List] = {}
        for e in scan.read_entries(snapshot):
            if e.bucket == -2:
                continue
            per_bucket.setdefault((e.partition, e.bucket), []) \
                .append(e.file)
        if not table.schema.primary_keys:
            trigger = table.options.get(
                CoreOptions.COMPACTION_MIN_FILE_NUM)
            return any(len(fs) >= trigger for fs in per_bucket.values())
        trigger = table.options.num_sorted_runs_compaction_trigger
        for files in per_bucket.values():
            runs = sum(1 for f in files if f.level == 0) + \
                len({f.level for f in files if f.level > 0})
            if runs >= trigger:
                return True
        return False

    def _compact_body(self):
        from paimon_tpu_torch.metrics import (
            STREAM_COMPACTIONS, STREAM_COMPACTIONS_PAUSED,
        )
        from paimon_tpu_torch.obs.trace import span

        o = self._o
        last_expire_at = time.monotonic()
        last_manifest_probe_at = time.monotonic()
        while not self._stop.wait(o["compact_interval_ms"] / 1000.0):
            if self._ingest_pressure():
                # graceful degradation: ingest pressure wins; try
                # again next round
                self._metrics.counter(STREAM_COMPACTIONS_PAUSED).inc()
                continue
            table = self._load()
            if self._needs_compaction(table):
                with span("stream.compact", cat="stream",
                          full=o["compact_full"]):
                    sid = table.compact(full=o["compact_full"])
                if sid is not None:
                    self._metrics.counter(STREAM_COMPACTIONS).inc()
            # manifest full-compaction, interval-gated: the trigger
            # probe itself reads the snapshot's manifest lists
            if o["manifest_compact_interval_ms"] is not None and \
                    (time.monotonic() - last_manifest_probe_at) * 1000 \
                    >= o["manifest_compact_interval_ms"]:
                last_manifest_probe_at = time.monotonic()
                with span("stream.compact_manifests", cat="stream"):
                    table.compact_manifests(force=False)
            if o["expire_interval_ms"] is not None and \
                    (time.monotonic() - last_expire_at) * 1000 \
                    >= o["expire_interval_ms"]:
                # NEVER expire the newest offset-carrying snapshot: it
                # is the recovery point; losing it would restart the
                # source from scratch and reuse commit identifiers.
                # Widening retain_min pins everything back to it.
                retain_min = None
                ckpt_snap = find_checkpoint_snapshot(table,
                                                     self.commit_user)
                latest = table.snapshot_manager.latest_snapshot_id()
                if ckpt_snap is not None and latest is not None:
                    retain_min = latest - ckpt_snap.id + 1
                table.expire_snapshots(
                    retain_min=retain_min,
                    retain_max=None if retain_min is None else max(
                        retain_min, table.options.get(
                            CoreOptions.SNAPSHOT_NUM_RETAINED_MAX)))
                last_expire_at = time.monotonic()

    # -- changelog serving loop ----------------------------------------------

    def _serve_body(self):
        from paimon_tpu_torch.metrics import (
            STREAM_CHANGELOG_ROWS, STREAM_FRESHNESS_MS,
        )
        from paimon_tpu_torch.obs.trace import span

        # serving progress is consumer state, so a restarted serving
        # loop (or daemon incarnation) RESUMES the stream instead of
        # scanning it all again; re-served batches are upsert-idempotent
        table = self._load({"consumer-id": f"{self.commit_user}-serve"})
        rb = table.new_read_builder()
        scan = rb.new_stream_scan()
        while True:
            if self._killed:
                return
            was_first = scan._first
            plan = scan.plan()
            if plan is None:
                if self._stop.is_set() and not self._ingest_alive():
                    # caught up AND the final checkpoint (committed by
                    # the ingest loop before it exited) has been served
                    return
                self._stop.wait(self._o["serve_poll_ms"] / 1000.0)
                continue
            if plan.splits:
                with span("stream.serve.batch", cat="stream",
                          snapshot=plan.snapshot_id) as sp:
                    rows = _rows(rb.new_read().to_arrow(plan))
                    # freshness means something only for follow-up
                    # deltas (a startup full scan spans all history)
                    freshness = None if was_first else \
                        self._freshness_ms(table, plan.snapshot_id)
                    if freshness is not None:
                        # event -> visible-in-changelog-scan latency,
                        # from the ingest ts the checkpoint committed
                        self._metrics.histogram(STREAM_FRESHNESS_MS) \
                            .update(freshness)
                        sp.set(freshness_ms=freshness)
                if not self._emit(rows):
                    return          # killed while blocked on the buffer
                self._metrics.counter(STREAM_CHANGELOG_ROWS) \
                    .inc(len(rows))
            # rows are delivered (bounded buffer): record consumer
            # progress so a restart resumes past this snapshot
            scan.notify_checkpoint_complete(scan.checkpoint())

    def _freshness_ms(self, table: FileStoreTable,
                      snapshot_id: Optional[int]) -> Optional[float]:
        if snapshot_id is None:
            return None
        try:
            snap = table.snapshot_manager.snapshot(snapshot_id)
        except (FileNotFoundError, OSError):
            return None
        props = snap.properties or {}
        if PROP_INGEST_TS not in props:
            return None           # not one of our ingest checkpoints
        return max(0.0, _now_ms() - int(props[PROP_INGEST_TS]))

    def _emit(self, rows: List[dict]) -> bool:
        """Bounded blocking enqueue: the serving loop stalls (never
        drops, never grows without bound) while consumers lag.  False
        when killed while waiting: the rows were NOT delivered, so the
        caller must not record progress past them."""
        cap = self._o["serve_buffer_rows"]
        i = 0
        with self._buf_cond:
            while i < len(rows):
                while len(self._buf) >= cap and not self._killed:
                    self._buf_cond.wait(0.2)
                if self._killed:
                    return False
                take = max(1, cap - len(self._buf))
                self._buf.extend(rows[i:i + take])
                i += take
                self._buf_cond.notify_all()
        return True
