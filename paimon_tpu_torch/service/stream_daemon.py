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

Distributed mode (host-death tolerance)
---------------------------------------

Passing `plane=MaintenancePlane(table, base_user=<commit_user>, ...)`
(parallel/maintenance_plane.py) turns one daemon per host into one
LOGICAL daemon over the shared table:

- **Sharded ingest.**  Every host sees the IDENTICAL CDC stream (the
  SPMD shape) but writes only the events whose (partition, bucket)
  it owns; offsets for a host's owned share are committed under its
  OWN commit user (`<base>-p<i>`), atomically with the data and with
  the plane's lease + ownership stamps.
- **Sharded maintenance.**  The compaction loop compacts only owned
  groups (the `group_filter` seam of compact_table / the mesh
  engine); snapshot expiry is ELECTED (lowest-ranked alive process)
  and protects EVERY live host's newest offset-carrying checkpoint;
  idle hosts renew their lease with heartbeat snapshots.
- **Sharded serving.**  Each host's serve loop ships only the
  changelog of owned buckets, under a per-host consumer id.
- **Takeover.**  When a peer's lease expires, the survivor adopts its
  buckets exactly-once: it BACKFILLS the gap between the dead peer's
  committed offset and its own from the replayable source (only the
  adopted groups, only offsets the dead peer had not committed), and
  publishes the backfill, the bumped ownership generation, and an
  offset FLOOR for the dead peer in ONE commit — so a crash
  mid-takeover redoes it from scratch and a crash after it never
  re-delivers.  The floor suppresses forward events the dead peer
  already wrote (its offset may be ahead of the survivor's).  The
  serve loop then catches up the adopted buckets from the dead
  peer's persisted consumer position before folding them into its
  own stream.  Recovery merges chains: a restarted survivor resumes
  its own offsets, re-reads its own stamped dead set and floors, and
  re-runs any takeover it had not durably published.
- **Rejoin.**  A host the recorded map calls dead restarts `rejoining`
  (parallel/maintenance_plane.py): it asks for readmission, the elected
  survivor readmits it in a new generation once every alive host's
  ledger covers it, each survivor stamps a rejoin floor, and the
  returner replays its offset gap up to the highest floor before
  forward ingest.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.table.table import FileStoreTable

__all__ = ["StreamDaemon", "recover_checkpoint", "checkpoint_once",
           "recover_max_identifier", "recover_plane_stamps",
           "find_checkpoint_snapshot", "PROP_OFFSET", "PROP_INGEST_TS",
           "PROP_FLOOR_PREFIX"]

PROP_OFFSET = "stream.source.offset"
PROP_INGEST_TS = "stream.ingest.ts-ms"
# survivor-stamped offset floor for an adopted dead peer: events at or
# below it in the peer's old buckets are ALREADY in the table (the
# peer committed them before dying) and must never be re-written
PROP_FLOOR_PREFIX = "stream.floor.p"
# THIS daemon's durable adoption ledger (csv of dead pids whose
# backfill it has published).  Deliberately separate from
# multihost.ownership.dead: the global dead set can reach my commit
# user through a heartbeat that merely relays another survivor's
# stamp — it must never convince a restarted ingest loop that MY
# share of a takeover was published when it wasn't
PROP_ADOPTED = "stream.adopted"

DEFAULT_COMMIT_USER = "stream-daemon"


def _now_ms() -> int:
    return int(time.time() * 1000)


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
    daemon user, from the newest snapshot carrying an offset property —
    (-1, 0) when the daemon has never checkpointed.  The offset is read
    from snapshot properties, so it is exactly as durable as the data
    it describes."""
    snap = find_checkpoint_snapshot(table, commit_user)
    if snap is None:
        return -1, 0
    return int(snap.properties[PROP_OFFSET]), snap.commit_identifier


def recover_max_identifier(table: FileStoreTable,
                           commit_user: str) -> int:
    """Largest NON-batch commit identifier this user ever committed.
    Distributed daemons need this beyond `recover_checkpoint`: a
    takeover-backfill commit carries an identifier but deliberately NO
    offset property, so recovering `last_ckpt` from the newest
    offset-carrying snapshot alone could reuse the backfill's
    identifier — and `filter_committed` would then silently drop the
    next real checkpoint as a replay."""
    from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER
    best = 0
    for snap in table.snapshot_manager.snapshots():
        if snap.commit_user != commit_user:
            continue
        if snap.commit_identifier == BATCH_COMMIT_IDENTIFIER:
            continue              # heartbeats / batch commits
        best = max(best, snap.commit_identifier)
    return best


def recover_plane_stamps(table: FileStoreTable, commit_user: str):
    """(this daemon's durable adoption ledger, its stamped floors
    {dead_pid: offset}) from the newest snapshot of `commit_user`
    carrying plane stamps.  A dead peer appears in the ledger
    (`stream.adopted`) exactly when THIS daemon's backfill commit for
    it landed — the global ownership dead set is deliberately not
    consulted, see PROP_ADOPTED."""
    from paimon_tpu_torch.parallel.distributed import has_ownership_stamp
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    earliest = sm.earliest_snapshot_id()
    if latest is None or earliest is None:
        return frozenset(), {}
    for sid in range(latest, earliest - 1, -1):
        try:
            snap = sm.snapshot(sid)
        except FileNotFoundError:
            continue
        if snap.commit_user != commit_user:
            continue
        props = snap.properties or {}
        if not has_ownership_stamp(props):
            continue
        adopted = frozenset(
            int(p) for p in (props.get(PROP_ADOPTED) or "").split(",")
            if p.strip())
        floors = {}
        for k, v in props.items():
            if k.startswith(PROP_FLOOR_PREFIX):
                try:
                    floors[int(k[len(PROP_FLOOR_PREFIX):])] = int(v)
                except ValueError:
                    continue
        return adopted, floors
    return frozenset(), {}


def checkpoint_once(table: FileStoreTable, source, *,
                    commit_user: str = DEFAULT_COMMIT_USER,
                    format: str = "debezium",
                    max_events: Optional[int] = None) -> Optional[int]:
    """One synchronous ingest step: recover the committed offset, pull
    every available event past it (up to `max_events`) and commit ONE
    checkpoint.  This is the daemon's ingest loop unrolled — and the
    crash-sweep surface for the offset-commit path: killing any
    mutating op inside it must leave a table that recovers to exactly
    one copy of every event."""
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
                    # crashed DURING drain (e.g. the final checkpoint
                    # commit failed): no restart is coming, so surface
                    # it — status()/CLI exit code must not report a
                    # clean drain that wasn't
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
        can see the triggering event plus the preceding ring."""
        from paimon_tpu_torch.obs import flight
        from paimon_tpu_torch.obs.trace import spool_flush
        flight.record(flight.EV_LOOP_CRASH, loop=self.name, why=why,
                      error=self.last_error, restarts=self.restarts)
        flight.dump()
        spool_flush()


class StreamDaemon:
    """Drive ingest + compaction + changelog serving over one table.

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
        from paimon_tpu_torch.obs.trace import sync_from_options

        self._dynamic = dict(dynamic_options or {})
        self.table = table.copy(self._dynamic) if self._dynamic else table
        self.device = self.table.device
        self.source = source
        self.format = format
        # distributed mode: `plane` is this host's MaintenancePlane
        # (parallel/maintenance_plane.py) — the daemon commits under a
        # per-host user, ingests/compacts/serves only owned buckets
        # and adopts a dead peer's share exactly-once
        self.plane = plane
        self._user_base = commit_user
        if plane is not None:
            if plane.base_user != commit_user:
                raise ValueError(
                    f"plane.base_user {plane.base_user!r} != daemon "
                    f"commit_user {commit_user!r}: heartbeats and "
                    f"checkpoints must share one per-host commit user")
            self.commit_user = plane.commit_user
        else:
            self.commit_user = commit_user
        o = self.table.options
        sync_from_options(o)
        from paimon_tpu_torch.obs import flight
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

        # distributed-mode state
        # commits (checkpoints, heartbeats, takeover backfills) of one
        # daemon serialize on this lock so a heartbeat can never stamp
        # a takeover generation whose backfill has not been published
        self._commit_lock = threading.Lock()
        # dead peers whose buckets MY chain has durably adopted (the
        # forward-ingest filter's dead set — may lag plane.ownership
        # while a backfill is pending, never leads it)
        self._ingest_dead: frozenset = frozenset()
        self._floors: Dict[int, int] = {}          # dead pid -> offset
        self._pending_adoptions: List[int] = []    # detector -> ingest
        self._pending_rejoins: List[int] = []      # grant queue (elected)
        self._pending_rejoin_acks: List[int] = []  # floor-stamp queue
        self._rejoin_replayed = 0                  # rows gap-replayed
        self._serve_adoptions: List[int] = []      # ingest -> serve
        self._serve_dead: frozenset = frozenset()
        if plane is not None:
            self._init_event_router()
            # heartbeats / forced adoption stamps must carry the
            # daemon's FULL property set (floors included): a
            # heartbeat stamping ownership without the active floors
            # would shadow them for recovery
            plane._file_store_commit().properties_provider = \
                self._plane_props

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
            # a loop is wedged (e.g. a consumer stopped draining the
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
        """Abrupt termination (the fault-injection/crash path): no
        final checkpoint, no serve catch-up.  Everything since the last
        committed checkpoint is intentionally lost; a new daemon on the
        same table + source replays it exactly once."""
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

        The handler flushes the trace spool and flight ring *before*
        initiating the drain: if the drain itself wedges and the
        process is then killed hard, the black box still made it to
        disk."""
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
        out = {
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
        if self.plane is not None:
            out["distributed"] = {
                "process_index": self.plane.process_index,
                "process_count": self.plane.process_count,
                "ownership_version": self.plane.ownership.version,
                "dead": sorted(self.plane.ownership.dead),
                "adopted": sorted(self._ingest_dead),
                "floors": dict(self._floors),
                "rejoining": self.plane.rejoining,
                "rejoin_replayed": self._rejoin_replayed,
            }
        return out

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
        (schema may have evolved), re-read the committed offset."""
        from paimon_tpu_torch.cdc.sink import CdcSinkWriter

        self._close_sink()
        table = self._load({"write-only": "true"})
        offset, last_ckpt = recover_checkpoint(table, self.commit_user)
        # in-memory floor: on a supervised IN-PROCESS restart, never
        # fall behind what this process already saw committed — if the
        # offset snapshot was expired/lost underneath us, regressing to
        # it (or to -1) would re-ingest committed events and reuse
        # identifiers
        self._offset = max(offset, self._offset)
        self._offset_pending = self._offset
        self._next_ckpt = max(last_ckpt + 1, self._next_ckpt)
        self._batch_first_pull_ms = None
        if self.plane is not None:
            # identifier floor over my WHOLE chain: backfill commits
            # carry identifiers but no offsets
            self._next_ckpt = max(
                self._next_ckpt,
                recover_max_identifier(table, self.commit_user) + 1)
            # my durable takeover ledger (dead set + floors stamped by
            # MY commits) — the global map on the plane may be ahead
            # (another survivor's stamp) or behind (nobody committed
            # since the takeover): pending adoptions are exactly the
            # globally-declared dead I have not durably adopted
            my_dead, floors = recover_plane_stamps(table,
                                                   self.commit_user)
            self._ingest_dead = frozenset(my_dead)
            merged = dict(floors)
            for j, f in self._floors.items():
                merged[j] = max(f, merged.get(j, f))
            self._floors = merged
            self.plane.refresh_view()
            self.plane.refresh_ownership()
            self._reconcile_adoptions()
            for j in sorted(self._ingest_dead):
                if j not in self._serve_dead and \
                        j not in self._serve_adoptions:
                    self._serve_adoptions.append(j)
        self._sink = CdcSinkWriter(table, format=self.format,
                                   commit_user=self.commit_user)
        if self.plane is not None:
            # plane stamps ride a PROVIDER (re-evaluated per CAS
            # attempt): a checkpoint losing its race to a peer's
            # takeover commit must re-stamp the NEW generation on
            # retry, not republish the stale one at the tip
            self._sink.properties_provider = self._plane_props

    def _close_sink(self):
        if self._sink is None:
            return
        try:
            self._sink.close()
        except Exception as e:                # noqa: BLE001
            # close() joins the flush pool; under injected store faults
            # it can re-raise the latched worker error. The sink is
            # being discarded either way — record, don't mask the
            # recovery that is about to run.
            self._metrics.counter("sink_close_errors").inc()
            self._last_close_error = f"{type(e).__name__}: {e}"
        self._sink = None

    # -- distributed routing + takeover (plane mode) -------------------------

    def _init_event_router(self):
        """Per-event (partition, bucket) routing with the SAME hash
        the write path uses (core/bucket.FixedBucketAssigner), so the
        ingest ownership split can never disagree with where the sink
        would actually put the row."""
        from paimon_tpu_torch.cdc.sink import _PARSERS
        from paimon_tpu_torch.core.bucket import FixedBucketAssigner
        schema = self.table.schema
        bucket_keys = schema.bucket_keys() or \
            schema.trimmed_primary_keys()
        if not bucket_keys:
            raise ValueError(
                "distributed stream daemons need a primary-key table: "
                "ownership shards on the bucket key")
        rt = schema.logical_row_type()
        self._assigner = FixedBucketAssigner(
            bucket_keys, [rt.get_field(k).type for k in bucket_keys],
            self.table.options.bucket)
        self._bucket_key_names = bucket_keys
        self._partition_key_names = schema.partition_keys
        self._key_schema = None
        self._parse_event = _PARSERS[self.format]

    def _event_group(self, event):
        """(partition, bucket) of one CDC event, or None for events
        that parse to no changes.  All changes of one pk event share
        the key, so the first change decides."""
        return self._event_groups([event])[0]

    def _event_groups(self, events) -> list:
        """[(partition, bucket) or None] for a whole poll batch: the
        bucket hash runs ONCE vectorized over the batch's key rows
        (core/bucket KeyHasher numpy path) instead of building a
        one-row table per event.  The per-row path (_event_group) is the oracle the equivalence test
        compares against."""
        import pyarrow as pa
        rows: list = []
        present: list = []
        for i, event in enumerate(events):
            changes = self._parse_event(event)
            if not changes:
                rows.append(None)
                continue
            rows.append(changes[0][0])
            present.append(i)
        groups: list = [None] * len(events)
        if not present:
            return groups
        if self._key_schema is None:
            arrow = self.table.arrow_schema()
            self._key_schema = pa.schema(
                [arrow.field(k) for k in self._bucket_key_names])
        sub = pa.Table.from_pylist(
            [{k: rows[i].get(k) for k in self._bucket_key_names}
             for i in present],
            schema=self._key_schema)
        buckets = self._assigner.assign(sub)
        for i, bucket in zip(present, buckets):
            part = tuple(rows[i].get(k)
                         for k in self._partition_key_names)
            groups[i] = (part, int(bucket))
        return groups

    def _forward_map(self):
        """The forward-ingest ownership map: the plane's topology with
        MY durably-adopted dead set — a takeover in flight (declared
        but not yet backfilled+published) must not leak adopted groups
        into forward writes, or backfilled rows would land with HIGHER
        sequence numbers than newer forward rows and win the merge."""
        from paimon_tpu_torch.parallel.distributed import OwnershipMap
        m = self.plane.ownership
        return OwnershipMap(m.version, m.num_processes, m.num_buckets,
                            self._ingest_dead)

    def _owns_forward_event(self, offset: int, event,
                            m=None) -> bool:
        return self._owns_forward_group(
            offset, self._event_group(event), m)

    def _owns_forward_group(self, offset: int, g,
                            m=None) -> bool:
        if g is None:
            return False
        part, bucket = g
        if m is None:
            m = self._forward_map()
        if m.owner_of(part, bucket) != self.plane.process_index:
            return False
        for j, floor in self._floors.items():
            if offset <= floor and self._was_owned_by(j, part, bucket):
                return False      # the dead peer committed this one
        return True

    def _was_owned_by(self, j: int, part, bucket) -> bool:
        """Did (part, bucket) belong to dead peer `j` immediately
        before its takeover?  EXACT: evaluated against the newest
        persisted generation in which j was alive
        (`GenerationHistory.map_governing` — the map that actually
        governed j's writes), so chained multi-death floors stay
        correct: with two peers dead, `current dead − {j}` would
        re-shard the OTHER victim's groups differently from any map j
        ever wrote under and mis-scope the floor.  Deterministic from
        persisted properties alone, so floors survive restarts.
        Falls back to the adopted-map-minus-j approximation only when
        the history was truncated past j (64-generation cap) or the
        topology changed since."""
        from paimon_tpu_torch.parallel.distributed import OwnershipMap
        m = self._forward_map()
        governing = self.plane.history.map_governing(j)
        if governing is not None and \
                (governing.num_processes, governing.num_buckets) == \
                (m.num_processes, m.num_buckets):
            return governing.owner_of(part, bucket) == j
        prev = OwnershipMap(m.version, m.num_processes, m.num_buckets,
                            frozenset(m.dead) - {j})
        return prev.owner_of(part, bucket) == j

    def _adopted_from(self, j: int, part, bucket) -> bool:
        """Group moves j -> ME in the takeover (my backfill share)."""
        from paimon_tpu_torch.parallel.distributed import OwnershipMap
        m = self._forward_map()
        if not self._was_owned_by(j, part, bucket):
            return False
        nxt = OwnershipMap(m.version, m.num_processes, m.num_buckets,
                           frozenset(m.dead) | {j})
        return nxt.owner_of(part, bucket) == self.plane.process_index

    def _floor_props(self) -> Dict[str, str]:
        """Active floors ride every checkpoint until the committed
        offset passes them (recovery re-reads them from my newest
        stamped snapshot)."""
        return {f"{PROP_FLOOR_PREFIX}{j}": str(f)
                for j, f in sorted(self._floors.items())
                if f > self._offset}

    def _adopt(self, j: int):
        """Adopt dead peer `j`'s share exactly-once.  Under the commit
        lock: backfill the gap between j's committed offset and MY
        POLL POSITION from the replayable source (adopted groups only,
        offsets j never committed), bump the plane generation, and
        publish backfill + new ownership + floor in ONE commit.  A
        crash before the commit leaves no trace (re-detected and
        redone); a crash after is durable in MY chain
        (`recover_plane_stamps`).

        The backfill upper bound is `_offset_pending`, NOT the
        committed `_offset`: events between the two were already
        polled (and their adopted-group share filtered out while j
        still owned it) — forward ingest resumes PAST them, so
        stopping the backfill at the committed offset would lose them
        forever.  Because the adoption commit then also publishes my
        in-flight forward rows up to `_offset_pending`, it carries the
        offset property whenever the offset actually advances (still
        strictly increasing)."""
        from paimon_tpu_torch.obs.trace import span

        dead_user = f"{self._user_base}-p{j}"
        off_j, _ = recover_checkpoint(self._sink.table, dead_user)
        off_i = self._offset_pending
        with span("stream.takeover", cat="stream", peer=j,
                  peer_offset=off_j, own_offset=off_i):
            with self._commit_lock:
                backfill = []
                cursor = off_j
                while cursor < off_i:
                    # bounded slices: a peer that died far behind must
                    # not buffer its whole gap at once — each slice is
                    # one vectorized bucket-hash (the batched router
                    # the ingest loop uses), and only the adopted
                    # subset is retained
                    polled = self.source.poll(cursor, 1 << 16)
                    if not polled:
                        break
                    window = [ev for off, ev in polled
                              if off <= off_i]
                    for ev, g in zip(window,
                                     self._event_groups(window)):
                        if g is not None and \
                                self._adopted_from(j, *g):
                            backfill.append(ev)
                    cursor = polled[-1][0]
                    if len(window) < len(polled):
                        break              # crossed off_i inside slice
                self._floors[j] = off_j
                self.plane.adopt({j})
                # ledger entry BEFORE the publishing commit so the
                # stamped PROP_ADOPTED includes j; a failed commit
                # crashes the loop and recovery re-reads the ledger
                # from the store
                self._ingest_dead = frozenset(self._ingest_dead) | {j}
                if backfill:
                    self._sink.write_events(backfill)
                # ONE commit publishes backfill + my pending forward
                # rows + bumped ownership + floor + ledger (the plane
                # stamps ride the sink's per-attempt provider;
                # force_create: with nothing buffered the stamps
                # alone must still be durable BEFORE any forward
                # write into the adopted groups)
                props = {}
                advanced = self._offset_pending > self._offset
                if advanced:
                    props[PROP_OFFSET] = str(self._offset_pending)
                    props[PROP_INGEST_TS] = str(
                        self._batch_first_pull_ms or _now_ms())
                ckpt = self._next_ckpt
                self._sink.commit(ckpt, properties=props,
                                  force_create=True)
                self._next_ckpt = ckpt + 1
                if advanced:
                    self._offset = self._offset_pending
                    self._batch_first_pull_ms = None
                self.plane.note_renewal()
        # hand the adopted buckets to the serve loop (it catches up
        # from the dead peer's persisted consumer position first)
        self._serve_adoptions.append(j)

    # -- coordinated rejoin (plane mode) -------------------------------------

    def _queue_rejoin_work(self) -> None:
        """Detector-cadence rejoin bookkeeping (compact loop): queue
        floor-stamp acks for peers some granter readmitted while MY
        ledger still holds them, and — on the elected granter — queue
        readmission grants for dead peers with a fresh rejoin
        request, but only once EVERY alive host's durable ledger
        covers them.  That ledger gate is the global drain of
        in-flight adoptions: readmitting earlier would strand a
        survivor's unpublished share of the victim's groups in a
        generation that no longer re-shards them to it."""
        back = frozenset(self._ingest_dead) - \
            frozenset(self.plane.ownership.dead)
        for j in sorted(back):
            if j not in self._pending_rejoin_acks:
                self._pending_rejoin_acks.append(j)
        if not self.plane.owns_rejoin_grant():
            return
        asking = self.plane.pending_rejoin_requests() - \
            frozenset(self._pending_rejoins)
        if not asking:
            return
        alive = [p for p in range(self.plane.process_count)
                 if p not in self.plane.ownership.dead]
        ledgers = {q: recover_plane_stamps(
            self.table, f"{self._user_base}-p{q}")[0] for q in alive}
        for j in sorted(asking):
            if all(j in ledgers[q] for q in alive):
                self._pending_rejoins.append(j)

    def _release_rejoined(self, returned) -> None:
        """Forget adopted state for peers that are alive again: their
        groups are theirs, my floors for them can only mis-suppress
        (the governing map is their NEW generation), and the serve
        loop must stop shipping their changelog."""
        self._ingest_dead = frozenset(self._ingest_dead) - returned
        for j in returned:
            self._floors.pop(j, None)
        self._serve_dead = frozenset(self._serve_dead) - returned
        self._serve_adoptions[:] = [j for j in self._serve_adoptions
                                    if j not in returned]

    def _ack_rejoins(self) -> None:
        """A granter readmitted peers MY durable ledger still holds:
        stop writing their groups and stamp MY rejoin floor —
        'everything I ever wrote into your groups is committed and
        ends here'.  ONE forced commit carries the floor together
        with my pending forward rows, so the floor is never published
        without the rows it bounds; the rejoiner's gap replay (up to
        the max granted floor) then supersedes my copies in offset
        order."""
        from paimon_tpu_torch.parallel.distributed import rejoin_floor_props
        with self._commit_lock:
            back = frozenset(self._pending_rejoin_acks) - \
                frozenset(self.plane.ownership.dead)
            self._pending_rejoin_acks.clear()
            back = back & frozenset(self._ingest_dead)
            if not back:
                return
            props = {}
            advanced = self._offset_pending > self._offset
            if advanced:
                props[PROP_OFFSET] = str(self._offset_pending)
                props[PROP_INGEST_TS] = str(
                    self._batch_first_pull_ms or _now_ms())
            for j in sorted(back):
                props.update(rejoin_floor_props(
                    self.plane.process_index, j,
                    self.plane.ownership.version,
                    self._offset_pending))
            self._release_rejoined(back)
            ckpt = self._next_ckpt
            self._sink.commit(ckpt, properties=props,
                              force_create=True)
            self._next_ckpt = ckpt + 1
            if advanced:
                self._offset = self._offset_pending
                self._batch_first_pull_ms = None
            self.plane.note_renewal()

    def _grant_rejoins(self) -> None:
        """The elected granter readmits every queued requester in ONE
        generation bump: one forced commit publishes the new map
        (requesters back ALIVE — the salted-crc32 shard hands each
        exactly its old primary groups, warm), the full generation
        history, MY rejoin floor for each, and my pending forward
        rows.  `fleet.rejoins` counts inside `readmit`, on the
        granter — two victims rejoining render rejoins 2."""
        from paimon_tpu_torch.obs.trace import span
        from paimon_tpu_torch.parallel.distributed import rejoin_floor_props
        returning = list(self._pending_rejoins)
        self._pending_rejoins.clear()
        with span("stream.rejoin.grant", cat="stream",
                  peers=returning):
            with self._commit_lock:
                granted = self.plane.readmit(returning)
                if not granted:
                    return
                props = {}
                advanced = self._offset_pending > self._offset
                if advanced:
                    props[PROP_OFFSET] = str(self._offset_pending)
                    props[PROP_INGEST_TS] = str(
                        self._batch_first_pull_ms or _now_ms())
                for j in sorted(granted):
                    props.update(rejoin_floor_props(
                        self.plane.process_index, j,
                        self.plane.ownership.version,
                        self._offset_pending))
                self._release_rejoined(granted)
                ckpt = self._next_ckpt
                self._sink.commit(ckpt, properties=props,
                                  force_create=True)
                self._next_ckpt = ckpt + 1
                if advanced:
                    self._offset = self._offset_pending
                    self._batch_first_pull_ms = None
                self.plane.note_renewal()

    def _rejoin(self) -> bool:
        """Blocking rejoin phase of a resurrected host (the ingest
        loop enters here when the plane constructed in the
        `rejoining` state):

          1. publish/refresh the rejoin request at lease cadence
             until the elected survivor readmits us;
          2. wait for a rejoin floor from every peer that was alive
             in the generation right before readmission — each floor
             bounds that peer's writes into our groups.  Peers
             readmitted WITH us never wrote past the survivors'
             floors (their adopted shares cascaded to the survivors
             when they died), and a peer that dies while we wait is
             dropped from the wait — its committed writes re-ingest
             idempotently past our replay;
          3. replay the offset gap (own committed, max floor] for the
             groups we own under the new map, in offset order, as ONE
             forced commit stamping offset=floor, then resume forward
             ingest past it.

        Returns False when killed/stopped mid-phase.  Crash-safe: a
        restart after readmission but before the replay commit finds
        `rejoining` already False and falls back to plain forward
        ingest from its committed offset, which re-writes the same
        gap rows (upsert-idempotent) under normal checkpoints."""
        from paimon_tpu_torch.obs.trace import span
        from paimon_tpu_torch.parallel.distributed import merge_rejoin_floors

        o = self._o
        plane = self.plane
        published = False
        while plane.rejoining:
            if self._killed or self._stop.is_set():
                return False
            if not published or plane.heartbeat_due():
                with self._commit_lock:
                    plane.request_rejoin()
                published = True
            plane.refresh_view()
            plane.refresh_ownership()  # clears rejoining on readmit
            if plane.rejoining:
                self._stop.wait(o["ingest_poll_ms"] / 1000.0)
        version = plane.ownership.version
        # peers readmitted alongside us (or us alone) were DEAD in the
        # generation the grant superseded; everyone else alive there
        # may have written into our groups and owes us a floor
        prev = plane.history.at(version - 1)
        if prev is not None and \
                prev.num_processes == plane.process_count:
            need = set(prev.alive())
        else:
            need = set(p for p in range(plane.process_count)
                       if p not in plane.ownership.dead) \
                - {plane.process_index}
        # our pre-death adoption ledger may hold peers that were
        # readmitted while we were down — they replayed their own
        # gaps; holding their floors would only mis-suppress
        self._release_rejoined(frozenset(self._ingest_dead) -
                               frozenset(plane.ownership.dead))
        # and adoptions queued during recovery for peers readmitted
        # meanwhile are stale — adopting an alive peer is nonsense
        self._pending_adoptions[:] = [
            j for j in self._pending_adoptions
            if j in plane.ownership.dead]
        table = self._sink.table
        floors: Dict[int, int] = {}
        while True:
            if self._killed or self._stop.is_set():
                return False
            floors.update(merge_rejoin_floors(
                table, plane.process_index, version, max_walk=128))
            plane.refresh_view()
            plane.refresh_ownership()
            # a peer that dies before stamping its floor would block
            # us forever: drop it — its committed writes into our
            # groups re-ingest idempotently past the replay
            need -= set(plane.ownership.dead)
            if need <= set(floors):
                break
            with self._commit_lock:
                plane.maybe_heartbeat()   # stay alive while waiting
            self._stop.wait(o["ingest_poll_ms"] / 1000.0)
        floor = max(floors.values(), default=self._offset)
        replayed = 0
        with span("stream.rejoin.replay", cat="stream",
                  committed=self._offset, floor=floor):
            with self._commit_lock:
                if floor > self._offset:
                    cursor = self._offset
                    while cursor < floor:
                        polled = self.source.poll(cursor, 1 << 16)
                        if not polled:
                            break
                        window = [ev for off, ev in polled
                                  if off <= floor]
                        fm = self._forward_map()
                        batch = []
                        for (off, ev), g in zip(
                                polled[:len(window)],
                                self._event_groups(window)):
                            if g is not None and \
                                    self._owns_forward_group(off, g,
                                                             fm):
                                batch.append(ev)
                        if batch:
                            self._sink.write_events(batch)
                            replayed += len(batch)
                        cursor = polled[-1][0]
                        if len(window) < len(polled):
                            break     # crossed the floor inside slice
                    props = {PROP_OFFSET: str(floor),
                             PROP_INGEST_TS: str(_now_ms())}
                    ckpt = self._next_ckpt
                    self._sink.commit(ckpt, properties=props,
                                      force_create=True)
                    self._next_ckpt = ckpt + 1
                    self._offset = floor
                    self._offset_pending = floor
                    plane.note_renewal()
        self._rejoin_replayed += replayed
        return True

    def _plane_props(self) -> Dict[str, str]:
        """Lease + ownership + floor + adoption-ledger stamps for one
        plane-issued commit (checkpoints, compactions, heartbeats,
        backfills)."""
        props = self.plane.stamp_properties()
        props.update(self._floor_props())
        if self._ingest_dead:
            props[PROP_ADOPTED] = ",".join(
                str(p) for p in sorted(self._ingest_dead))
        return props

    def _reconcile_adoptions(self, newly=()) -> None:
        """Queue every dead peer MY ledger has not durably adopted:
        freshly-declared ones (`newly`, from my own detector) AND
        peers whose takeover another survivor already published into
        the global map — without the latter, a 3-host mesh where a
        faster survivor publishes first would leave this host's
        re-sharded share of the dead peer's buckets unwritten until
        its next restart (its detector suppresses peers already in
        `ownership.dead`).  No-op when
        multihost.maintenance.takeover is off: the detector still
        counts lease_expired, ownership stays frozen."""
        if not self.plane.takeover_enabled:
            return
        behind = frozenset(newly) | \
            (frozenset(self.plane.ownership.dead) - self._ingest_dead)
        # never self: a rejoining host recovering against a map that
        # still records IT dead must not queue its own adoption
        behind -= {self.plane.process_index}
        for j in sorted(behind):
            if j not in self._pending_adoptions and \
                    j not in self._ingest_dead:
                self._pending_adoptions.append(j)

    def _ingest_body(self):
        from paimon_tpu_torch.metrics import (
            STREAM_EVENTS_INGESTED, STREAM_SOURCE_BACKLOG,
        )
        from paimon_tpu_torch.obs.trace import span

        self._ingest_recover()
        if self.plane is not None and self.plane.rejoining:
            # resurrected host: blocking rejoin phase (request ->
            # readmission -> gap replay) before any forward ingest
            if not self._rejoin():
                return
        o = self._o
        last_ckpt_at = time.monotonic()
        while True:
            if self._killed:
                return
            if self.plane is not None and self._pending_adoptions:
                # adoption runs BEFORE any forward write past it: a
                # forward row in an adopted group written before the
                # backfill would end up with a LOWER sequence number
                # than the backfilled (older) row and lose the merge
                self._adopt(self._pending_adoptions.pop(0))
                continue
            if self.plane is not None and self._pending_rejoin_acks:
                self._ack_rejoins()
                continue
            if self.plane is not None and self._pending_rejoins:
                # grants run only with the adoption queue drained:
                # readmission must never race my own pending backfill
                self._grant_rejoins()
                continue
            stopping = self._stop.is_set()
            events = [] if stopping else self.source.poll(
                self._offset_pending, o["max_batch"])
            now_mono = time.monotonic()
            if events:
                if self._batch_first_pull_ms is None:
                    self._batch_first_pull_ms = _now_ms()
                if self.plane is None:
                    mine = [e for _, e in events]
                else:
                    # SPMD split: every host sees the identical
                    # stream; each writes only its owned share (plus
                    # floor suppression for adopted groups).  One
                    # forward map AND one vectorized bucket-hash per
                    # poll batch — the map only changes under the
                    # commit lock, never mid-poll
                    fm = self._forward_map()
                    groups = self._event_groups(
                        [e for _, e in events])
                    mine = [e for (off, e), g in zip(events, groups)
                            if self._owns_forward_group(off, g, fm)]
                with span("stream.ingest.batch", cat="stream",
                          events=len(events), owned=len(mine),
                          first=events[0][0], last=events[-1][0]):
                    # write_events blocks on write.flush.max-bytes:
                    # THE backpressure coupling — no internal queue
                    if mine:
                        self._sink.write_events(mine)
                self._offset_pending = events[-1][0]
                self._metrics.counter(STREAM_EVENTS_INGESTED) \
                    .inc(len(mine))
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
        # (distributed mode: lease/ownership/floor/ledger stamps ride
        # the sink's properties_provider, evaluated per CAS attempt —
        # NOT merged here, where they would be stale on retry)
        with span("stream.checkpoint", cat="stream", group="stream",
                  metric=STREAM_CHECKPOINT_MS, checkpoint=ckpt,
                  offset=self._offset_pending):
            if self.plane is None:
                self._sink.commit(ckpt, properties=props)
            else:
                with self._commit_lock:
                    # force_create: my share of the window may hold no
                    # events, but the offset (and the lease) must
                    # still advance — an offset-only stamped snapshot
                    self._sink.commit(ckpt, properties=props,
                                      force_create=True)
                    self.plane.note_renewal()
        # past this line the checkpoint is durable: advance in-memory
        # state (a crash between commit and here replays the
        # checkpoint, which filter_committed + pending-keying dedup)
        self._offset = self._offset_pending
        self._next_ckpt = ckpt + 1
        self._batch_first_pull_ms = None
        self._metrics.counter(STREAM_CHECKPOINTS).inc()
        # drop floors the committed offset has passed (they can no
        # longer suppress anything and stop being stamped)
        for j in [j for j, f in self._floors.items()
                  if f <= self._offset]:
            del self._floors[j]
        # sources that cache events may evict everything at/below the
        # now-durable offset (FileCdcSource bounds its memory this way)
        # — but NOT in distributed mode: a dead peer's un-adopted
        # offsets may still need events at/below MY offset
        commit_through = getattr(self.source, "commit_through", None)
        if commit_through is not None and self.plane is None:
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
        """Level/size trigger: any bucket at/over the sorted-run
        trigger (pk tables: level-0 files each count as a run, higher
        levels one run each — compact/levels.py semantics) or, for
        append tables, at/over compaction.min.file-num.  Distributed:
        only OWNED groups trigger — a peer's backlog is the peer's
        job (or the survivor's, after takeover re-owns it)."""
        snapshot = table.latest_snapshot()
        if snapshot is None:
            return False
        scan = table.new_scan()
        per_bucket: Dict[tuple, List] = {}
        for e in scan.read_entries(snapshot):
            if e.bucket == -2:
                continue
            if self.plane is not None and not self.plane.owns(
                    tuple(scan._partition_codec.from_bytes(e.partition)),
                    e.bucket):
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

    def _expiry_floor(self, table: FileStoreTable) -> Optional[int]:
        """Lowest snapshot id the elected expiry must keep: every
        peer's newest offset-carrying checkpoint — INCLUDING a dead
        peer's, until EVERY alive process's durable adoption ledger
        covers it.  The global dead set alone is not enough: one
        survivor's published takeover puts the peer in
        `ownership.dead` while another survivor's backfill may still
        be pending, and that backfill reads the dead peer's committed
        offset — expiring it would regress the floor to -1 and
        re-deliver the peer's whole history."""
        alive = [p for p in range(self.plane.process_count)
                 if p not in self.plane.ownership.dead]
        ledgers = {p: recover_plane_stamps(
            table, f"{self._user_base}-p{p}")[0] for p in alive}
        protected = []
        for p in range(self.plane.process_count):
            if p in self.plane.ownership.dead and \
                    all(p in ledgers[q] for q in alive):
                continue          # fully adopted: offsets subsumed
            snap = find_checkpoint_snapshot(
                table, f"{self._user_base}-p{p}")
            if snap is not None:
                protected.append(snap.id)
        return min(protected) if protected else None

    def _compact_body(self):
        from paimon_tpu_torch.metrics import (
            STREAM_COMPACTIONS, STREAM_COMPACTIONS_PAUSED,
        )
        from paimon_tpu_torch.obs.trace import span

        o = self._o
        last_expire_at = time.monotonic()
        last_manifest_probe_at = time.monotonic()
        while not self._stop.wait(o["compact_interval_ms"] / 1000.0):
            if self.plane is not None:
                # failure-detector round: newly-expired peers (and
                # peers other survivors already published as dead)
                # queue for the ingest loop's exactly-once adoption —
                # the backfill must publish atomically with the
                # ownership bump, so the detector never adopts
                # directly here
                self._reconcile_adoptions(self.plane.detect_expired())
                # rejoin bookkeeping rides the same detector cadence:
                # queue grants (elected) and floor-stamp acks for the
                # ingest loop — like adoption, the generation change
                # must publish atomically with the rows it bounds
                self._queue_rejoin_work()
                # idle hosts still renew their lease
                with self._commit_lock:
                    self.plane.maybe_heartbeat()
            if self._ingest_pressure():
                # graceful degradation: ingest pressure wins; try
                # again next round
                self._metrics.counter(STREAM_COMPACTIONS_PAUSED).inc()
                continue
            table = self._load()
            if self._needs_compaction(table):
                with span("stream.compact", cat="stream",
                          full=o["compact_full"]):
                    if self.plane is None:
                        sid = table.compact(full=o["compact_full"])
                    else:
                        # owned groups only, committed under the
                        # per-host user with per-attempt lease/
                        # ownership stamps
                        sid = table.compact(
                            full=o["compact_full"],
                            group_filter=self.plane.group_filter(),
                            commit_user=self.commit_user,
                            properties_provider=self._plane_props)
                        if sid is not None:
                            self.plane.note_renewal()
                if sid is not None:
                    self._metrics.counter(STREAM_COMPACTIONS).inc()
            # manifest full-compaction (incremental metadata plane):
            # elected like expiry on the mesh — one host folds the
            # accumulated delta manifests once the count trigger
            # fires; CAS-committed, so a racing peer just retries.
            # Interval-gated like expiry: the trigger probe itself
            # reads the snapshot's manifest lists, so running it on
            # every 2s compact tick is continuous wasted metadata IO
            if o["manifest_compact_interval_ms"] is not None and \
                    (self.plane is None or self.plane.owns_expiry()) \
                    and (time.monotonic() - last_manifest_probe_at) \
                    * 1000 >= o["manifest_compact_interval_ms"]:
                last_manifest_probe_at = time.monotonic()
                with span("stream.compact_manifests", cat="stream"):
                    if self.plane is None:
                        msid = table.compact_manifests(force=False)
                    else:
                        msid = table.compact_manifests(
                            force=False, commit_user=self.commit_user,
                            properties_provider=self._plane_props)
                        if msid is not None:
                            self.plane.note_renewal()
            if o["expire_interval_ms"] is not None and \
                    (self.plane is None or self.plane.owns_expiry()) \
                    and (time.monotonic() - last_expire_at) * 1000 \
                    >= o["expire_interval_ms"]:
                # NEVER expire the newest offset-carrying snapshot: it
                # is the recovery point — losing it would restart the
                # source from scratch and reuse commit identifiers.
                # Widening retain_min pins everything back to it (an
                # idle source under active compaction is exactly when
                # newer non-ingest snapshots would otherwise push it
                # out of the retention window).  Distributed (expiry
                # is ELECTED, lowest-ranked alive host): protect
                # EVERY live peer's recovery point via the absolute
                # floor — a dead-but-unadopted peer's too, since a
                # takeover still needs its committed offset.
                retain_min = None
                floor_id = None
                if self.plane is None:
                    ckpt_snap = find_checkpoint_snapshot(
                        table, self.commit_user)
                    latest = \
                        table.snapshot_manager.latest_snapshot_id()
                    if ckpt_snap is not None and latest is not None:
                        retain_min = latest - ckpt_snap.id + 1
                else:
                    floor_id = self._expiry_floor(table)
                table.expire_snapshots(
                    retain_min=retain_min,
                    retain_max=None if retain_min is None else max(
                        retain_min, table.options.get(
                            CoreOptions.SNAPSHOT_NUM_RETAINED_MAX)),
                    min_retained_snapshot_id=floor_id)
                last_expire_at = time.monotonic()

    # -- changelog serving loop ----------------------------------------------

    def _serve_ownership_splits(self, splits):
        """Distributed serving: ship only the changelog of buckets
        this host owns AS FAR AS THE SERVE LOOP KNOWS (`_serve_dead`
        may lag the ingest ledger until the catch-up for an adopted
        peer has replayed its backlog — serving new deltas of adopted
        buckets before the backlog would reorder the stream)."""
        from paimon_tpu_torch.parallel.distributed import OwnershipMap
        m = self.plane.ownership
        serve_map = OwnershipMap(m.version, m.num_processes,
                                 m.num_buckets, self._serve_dead)
        return [s for s in splits
                if serve_map.owner_of(tuple(s.partition), s.bucket)
                == self.plane.process_index]

    def _serve_catch_up(self, j: int, upto: Optional[int]) -> bool:
        """Replay the changelog of the buckets adopted from dead peer
        `j`, from the peer's persisted consumer position up to (not
        including) snapshot `upto` — where my own serve stream will
        take over.  The peer may have served rows past its recorded
        position (consumer state trails delivery); re-serving that
        suffix is upsert-idempotent for consumers, like every other
        restart in this daemon.  Returns False when killed mid-replay
        (progress is NOT recorded; the next incarnation redoes it)."""
        from dataclasses import replace

        from paimon_tpu_torch.metrics import STREAM_CHANGELOG_ROWS
        from paimon_tpu_torch.obs.trace import span

        table = self._load()
        cm = table.consumer_manager
        dead_consumer = f"{self._user_base}-p{j}-serve"
        pj = cm.consumer(dead_consumer)
        rb = table.new_read_builder()
        scan = rb.new_stream_scan()
        scan.restore(pj)          # None -> initial full-state replay
        with span("stream.serve.takeover", cat="stream", peer=j,
                  peer_position=pj, upto=upto):
            while True:
                if self._killed:
                    return False
                was_first = scan._first
                plan = scan.plan()
                if plan is None:
                    break
                if not was_first and upto is not None and \
                        plan.snapshot_id is not None and \
                        plan.snapshot_id >= upto:
                    break         # my own stream serves from here on
                if plan.splits:
                    splits = [s for s in plan.splits
                              if self._adopted_from(
                                  j, tuple(s.partition), s.bucket)]
                    if splits:
                        rows = _rows(rb.new_read().to_arrow(
                            replace(plan, splits=splits)))
                        if not self._emit(rows):
                            return False
                        self._metrics.counter(STREAM_CHANGELOG_ROWS) \
                            .inc(len(rows))
        # release the dead consumer's expiry pin: my own consumer
        # carries the adopted buckets from `upto` onward
        if upto is not None:
            cm.record_consumer(dead_consumer, upto)
        return True

    def _serve_body(self):
        from paimon_tpu_torch.metrics import (
            STREAM_CHANGELOG_ROWS, STREAM_FRESHNESS_MS,
        )
        from paimon_tpu_torch.obs.trace import span

        # persist serving progress as consumer state so a restarted
        # serving loop (or daemon incarnation) RESUMES the stream
        # instead of full-rescanning — resuming replays every delta
        # (including delete tombstones) exactly from where consumers
        # last got rows, and re-served batches are upsert-idempotent
        table = self._load({"consumer-id": f"{self.commit_user}-serve"})
        rb = table.new_read_builder()
        scan = rb.new_stream_scan()
        while True:
            if self._killed:
                return
            if self.plane is not None and self._serve_adoptions:
                # adopted-bucket catch-up runs IN the serve thread so
                # the main stream cannot advance underneath it: replay
                # the dead peer's backlog up to my current position,
                # then fold the adopted buckets into my own filter
                j = self._serve_adoptions[0]
                upto = scan.checkpoint()
                if upto is None:
                    # my own stream has not started: its initial
                    # full-state scan will cover the adopted buckets
                    self._serve_adoptions.pop(0)
                    self._serve_dead = \
                        frozenset(self._serve_dead) | {j}
                    continue
                if not self._serve_catch_up(j, upto):
                    return        # killed mid-replay
                self._serve_adoptions.pop(0)
                self._serve_dead = frozenset(self._serve_dead) | {j}
                continue
            was_first = scan._first
            plan = scan.plan()
            if plan is None:
                if self._stop.is_set() and not self._ingest_alive():
                    # caught up AND the final checkpoint (committed by
                    # the ingest loop before it exited) has been served
                    return
                self._stop.wait(self._o["serve_poll_ms"] / 1000.0)
                continue
            if self.plane is not None:
                from dataclasses import replace
                plan = replace(
                    plan,
                    splits=self._serve_ownership_splits(plan.splits))
            if plan.splits:
                with span("stream.serve.batch", cat="stream",
                          snapshot=plan.snapshot_id) as sp:
                    rows = _rows(rb.new_read().to_arrow(plan))
                    # freshness is only meaningful for follow-up
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
        when killed while waiting — the rows were NOT delivered, so
        the caller must not record progress past them."""
        cap = self._o["serve_buffer_rows"]
        i = 0
        with self._buf_cond:
            while i < len(rows):
                while len(self._buf) >= cap and not self._killed:
                    self._buf_cond.wait(0.2)
                if self._killed:
                    # partially-delivered batch: progress is NOT
                    # recorded, the next incarnation re-serves it
                    # (upsert-idempotent for consumers)
                    return False
                take = max(1, cap - len(self._buf))
                self._buf.extend(rows[i:i + take])
                i += take
                self._buf_cond.notify_all()
        return True
