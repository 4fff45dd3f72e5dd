"""Mesh-sharded maintenance plane: lease-based, takeover-capable
bucket ownership for compaction, expiry and changelog serving.

Counterpart of paimon_tpu/parallel/maintenance_plane.py.  It extends
the write plane's deterministic (partition, bucket) ownership
(parallel/distributed.py) to every background plane, so that one host's
death stalls neither compaction table-wide nor the streaming daemon.
The protocol is in store terms only (a dead host cannot join a
collective, so nothing here needs one):

**Leases.**  Every plane-issued commit (stream checkpoints, compaction
snapshots, heartbeats) stamps `multihost.lease.p<i>` properties through
`FileStoreCommit.properties_provider`: the committer's wall-clock
renewal and its last-known view of every peer's renewal (a max-merge
CRDT: readers fold the last few snapshots, so concurrent committers
cannot regress each other).  An idle host publishes a small heartbeat
snapshot every `multihost.lease.interval`.

**Failure detection.**  A participant whose newest renewal is older than
`multihost.lease.timeout` is presumed dead.  The input is store state
(the max-merged lease view), so every survivor reaches the same verdict
on its own; the collectives of parallel/multihost.py arbitrate only
transitions of the live cohort (bring-up, distributed rescale), never
death: a collective with a dead member cannot complete.

**Takeover.**  A dead host's groups are re-sharded over the survivors by
the same salted crc32 that sharded them (`distributed.owner_of(dead=
...)`), so N survivors compute one takeover map with no communication.
The adoption bumps the ownership version and records the dead set in
snapshot properties on the adopter's next commit.  A dead host that
comes back is READMITTED through the coordinated rejoin: it constructs
its plane `rejoining` (owning nothing), publishes a rejoin request
whose liveness rides its own lease, and the elected alive host bumps the
generation with the returner back in, which hands it exactly its old
primary groups.  Every generation is kept in
`multihost.ownership.history`, so `owner_of` at any recorded version is
exact.  `multihost.rejoin.enabled=false` refuses the returner with
`OwnershipError`.

The clock is injectable (`clock=`, ms): tests drive takeover and rejoin
with it, not with sleeps.  Everything degrades to one process: the map
owns everything, the detector sees no peers and no heartbeat is sent.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, FrozenSet, Optional, Tuple

from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.parallel.distributed import (
    GenerationHistory, OwnershipError, OwnershipMap, lease_props,
    merge_lease_view, merge_rejoin_requests, rejoin_request_props,
    resume_generation_history,
)

__all__ = ["MaintenancePlane"]


def _now_ms() -> int:
    return int(_time.time() * 1000)


class MaintenancePlane:
    """One process's slice of the sharded maintenance plane over a
    fixed-bucket table.

    Usage (identical on every host; no collectives required):

        plane = MaintenancePlane(table, base_user="stream-daemon")
        plane.ensure_lease()                  # initial renewal
        ...
        if plane.owns(partition, bucket): compact/serve it
        if plane.owns_expiry(): expire snapshots
        newly_dead = plane.detect_and_take_over()
        plane.maybe_heartbeat()               # idle renewal
    """

    def __init__(self, table, base_user: str = "maint",
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 clock: Optional[Callable[[], int]] = None):
        from paimon_tpu_torch.parallel import multihost as MH

        self.table = table
        self.base_user = base_user
        self.process_index = (MH.process_index()
                              if process_index is None else process_index)
        self.process_count = (MH.process_count()
                              if process_count is None else process_count)
        self._clock = clock or _now_ms
        o = table.options
        self.lease_interval_ms = o.get(
            CoreOptions.MULTIHOST_LEASE_INTERVAL)
        self.lease_timeout_ms = o.get(CoreOptions.MULTIHOST_LEASE_TIMEOUT)
        self.takeover_enabled = o.get(
            CoreOptions.MULTIHOST_MAINTENANCE_TAKEOVER)
        self.lease_walk = o.get(
            CoreOptions.MULTIHOST_MAINTENANCE_LEASE_WALK)
        if table.options.bucket < 1:
            raise OwnershipError(
                "the maintenance plane needs a fixed-bucket table "
                f"(bucket={table.options.bucket})")

        from paimon_tpu_torch.metrics import (
            FLEET_FSCK_INCREMENTAL_RUNS, FLEET_FSCK_OBJECTS_CHECKED,
            FLEET_FSCK_WATERMARK_AGE_MS, FLEET_GENERATIONS,
            FLEET_REJOINS, MULTIHOST_LEASE_EXPIRED,
            MULTIHOST_LEASE_RENEWALS, MULTIHOST_MAINTENANCE_TAKEOVERS,
            MULTIHOST_OWNED_BUCKETS, global_registry,
        )
        self._metrics = global_registry().multihost_metrics()
        # pre-allocate the maintenance series, as the write plane does:
        # a run with zero takeovers must render maintenance_takeovers 0
        # on Prometheus, not omit the series
        for c in (MULTIHOST_MAINTENANCE_TAKEOVERS,
                  MULTIHOST_LEASE_RENEWALS, MULTIHOST_LEASE_EXPIRED):
            self._metrics.counter(c)
        self._metrics.gauge(MULTIHOST_OWNED_BUCKETS)
        # the fleet group rides the same pre-allocation rule: a soak
        # with zero rejoins must render rejoins 0, and the fsck
        # series exist even before the first incremental sweep
        self._fleet = global_registry().fleet_metrics()
        for c in (FLEET_REJOINS, FLEET_FSCK_INCREMENTAL_RUNS,
                  FLEET_FSCK_OBJECTS_CHECKED):
            self._fleet.counter(c)
        self._fleet.gauge(FLEET_GENERATIONS)
        self._fleet.gauge(FLEET_FSCK_WATERMARK_AGE_MS)

        # a host the recorded map calls DEAD owns nothing until the
        # elected survivor readmits it; `rejoining` gates that state
        self.rejoining = False
        rejoin_enabled = o.get(CoreOptions.MULTIHOST_REJOIN_ENABLED)
        recorded_history = resume_generation_history(table)
        recorded = (recorded_history.current()
                    if recorded_history is not None else None)
        buckets = table.options.bucket
        if recorded is None:
            self.ownership = OwnershipMap(1, self.process_count, buckets)
        elif (recorded.num_processes, recorded.num_buckets) == \
                (self.process_count, buckets):
            if self.process_index in recorded.dead:
                if not rejoin_enabled:
                    raise OwnershipError(
                        f"process {self.process_index} is recorded "
                        f"DEAD in ownership generation "
                        f"{recorded.version}; its buckets were adopted "
                        f"by survivors and multihost.rejoin.enabled is "
                        f"false.  Rejoin is a coordinated new plane "
                        f"generation across the whole cohort, not a "
                        f"silent restart")
                # coordinated rejoin: keep the recorded generation
                # (self still dead, owning nothing) and wait to be
                # readmitted — request_rejoin() publishes the ask
                self.rejoining = True
            # survivors keep the recorded generation — INCLUDING its
            # dead set; the dead host is still dead across restarts
            self.ownership = recorded
        else:
            # topology changed (resized cohort / legacy tip): a new
            # ownership function needs a new version
            self.ownership = OwnershipMap(recorded.version + 1,
                                          self.process_count, buckets)
        self.history = (recorded_history
                        or GenerationHistory.initial(self.ownership)
                        ).with_map(self.ownership)
        self._start_ms = self._clock()
        # last-known lease view, max-merged from the store at refresh
        # points + own in-memory renewals (never regress own entry)
        self._view: Dict[int, int] = merge_lease_view(
            table, self.lease_walk)
        # peers THIS detector already declared dead (lease_expired is
        # counted once per peer, and detect_expired never re-returns
        # a declaration the caller is still acting on)
        self._declared: set = set(self.ownership.dead)
        self._commit = None
        # trace context of the detector round that adopted a dead
        # peer; rides the NEXT stamped commit as `trace.context` so
        # the published takeover links back to the detection span in
        # the merged fleet trace (volatile like the adoption itself)
        self._takeover_ctx: Optional[str] = None
        self._update_owned_gauge()
        self._update_generation_gauge()

    # -- wiring --------------------------------------------------------------

    @property
    def commit_user(self) -> str:
        return f"{self.base_user}-p{self.process_index}"

    def stamp_properties(self) -> Dict[str, str]:
        """Ownership + lease properties for one plane-issued commit —
        hang this on `FileStoreCommit.properties_provider` (or merge
        into explicit commit properties) so EVERY commit the plane
        issues stamps them: under plane-only traffic the tip is
        always stamped and `resume_ownership_map` never has to walk
        past foreign snapshots.

        Refreshes the generation from the store first: a commit that
        lost its CAS race to a peer's takeover re-evaluates this per
        attempt (core/commit.py), and WITHOUT the refresh it would
        stamp its stale in-memory version at the new tip — an
        ownership regression `resume_ownership_map` would resume and
        fsck would (rightly) flag.  Cheap in the common case: the tip
        itself is stamped, so the walk is one snapshot deep."""
        self.refresh_ownership()
        props = self.history.to_properties()
        props.update(lease_props(self.process_index, self._clock(),
                                 self._view))
        if self._takeover_ctx is not None:
            props.setdefault("trace.context", self._takeover_ctx)
            self._takeover_ctx = None
        return props

    def attach(self, file_store_commit) -> None:
        """Stamp every commit the given FileStoreCommit publishes."""
        file_store_commit.properties_provider = self.stamp_properties

    def note_renewal(self, now_ms: Optional[int] = None) -> None:
        """Record that a stamped commit LANDED (the renewal is durable)."""
        from paimon_tpu_torch.metrics import MULTIHOST_LEASE_RENEWALS
        now = self._clock() if now_ms is None else now_ms
        self._view[self.process_index] = max(
            now, self._view.get(self.process_index, 0))
        self._metrics.counter(MULTIHOST_LEASE_RENEWALS).inc()

    # -- ownership filters ---------------------------------------------------

    def owns(self, partition: Tuple, bucket: int) -> bool:
        return self.ownership.owner_of(tuple(partition), int(bucket)) \
            == self.process_index

    def group_filter(self) -> Callable[[Tuple, int], bool]:
        """(partition, bucket) -> owned?  — the scheduling filter for
        compact_table / compact_table_mesh / changelog serving."""
        return self.owns

    def owns_expiry(self) -> bool:
        """Snapshot/changelog expiry is table-global, not per-bucket:
        it is ELECTED — the lowest-ranked ALIVE process runs it, so a
        dead expiry owner's duty fails over deterministically."""
        alive = self.ownership.alive()
        return bool(alive) and self.process_index == min(alive)

    def _update_owned_gauge(self):
        from paimon_tpu_torch.metrics import MULTIHOST_OWNED_BUCKETS
        owned = sum(1 for b in range(self.ownership.num_buckets)
                    if self.ownership.owner_of((), b)
                    == self.process_index)
        self._metrics.gauge(MULTIHOST_OWNED_BUCKETS).set(owned)

    def _update_generation_gauge(self):
        from paimon_tpu_torch.metrics import FLEET_GENERATIONS
        self._fleet.gauge(FLEET_GENERATIONS).set(self.ownership.version)

    # -- leases + failure detection ------------------------------------------

    def refresh_view(self) -> Dict[int, int]:
        """Max-merge the store's recent lease stamps into the local
        view (detector input).  Own entries never regress."""
        stored = merge_lease_view(self.table, self.lease_walk)
        for p, ms in stored.items():
            if ms > self._view.get(p, -1):
                self._view[p] = ms
        return dict(self._view)

    def refresh_ownership(self) -> bool:
        """Adopt a HIGHER ownership generation recorded in the store
        (another survivor completed a takeover first, readmitted a
        rejoiner, or the write plane rescaled).  Returns True when the
        map changed.  Versions only ever move forward — the fsck
        ownership check relies on chain monotonicity."""
        recorded_history = resume_generation_history(self.table)
        recorded = (recorded_history.current()
                    if recorded_history is not None else None)
        if recorded is None or recorded.version <= self.ownership.version:
            return False
        if (recorded.num_processes, recorded.num_buckets) != \
                (self.process_count, self.ownership.num_buckets):
            return False          # foreign topology: not ours to adopt
        self.ownership = recorded
        self.history = recorded_history
        # a peer the new generation readmitted is declarable AGAIN if
        # it dies again — forget the old declaration
        self._declared = {p for p in self._declared
                          if p in recorded.dead}
        if self.rejoining and self.process_index not in recorded.dead:
            # the elected survivor readmitted us: we own our groups
            # again (the caller still replays its offset gap before
            # forward work — service/stream_daemon.py)
            self.rejoining = False
        self._update_owned_gauge()
        self._update_generation_gauge()
        return True

    def lease_age_ms(self, process: int,
                     now_ms: Optional[int] = None) -> int:
        """Ms since `process` last renewed; a process never seen ages
        from plane construction (grace for slow bring-up)."""
        now = self._clock() if now_ms is None else now_ms
        return now - self._view.get(process, self._start_ms)

    def expired_processes(self, now_ms: Optional[int] = None
                          ) -> FrozenSet[int]:
        """Peers (never self) whose lease is older than the timeout
        and who are not already recorded dead."""
        now = self._clock() if now_ms is None else now_ms
        return frozenset(
            p for p in range(self.process_count)
            if p != self.process_index
            and p not in self.ownership.dead
            and self.lease_age_ms(p, now) > self.lease_timeout_ms)

    def detect_expired(self, now_ms: Optional[int] = None,
                       refresh: bool = True) -> FrozenSet[int]:
        """One failure-detector round WITHOUT adoption: refresh the
        lease view and return peers newly past the timeout (each is
        declared — and counted into lease_expired — exactly once).
        The distributed stream daemon uses this split so the
        ownership bump can ride the SAME commit as its offset
        backfill: declaring and adopting in one step would let a
        heartbeat stamp a takeover whose backfill never published."""
        from paimon_tpu_torch.metrics import MULTIHOST_LEASE_EXPIRED
        if self.process_count <= 1:
            return frozenset()
        if refresh:
            self.refresh_view()
            self.refresh_ownership()
        newly = frozenset(p for p in self.expired_processes(now_ms)
                          if p not in self._declared)
        if newly:
            self._declared |= newly
            self._metrics.counter(MULTIHOST_LEASE_EXPIRED).inc(
                len(newly))
            from paimon_tpu_torch.obs.flight import EV_LEASE_EXPIRED, record
            record(EV_LEASE_EXPIRED, detector=self.process_index,
                   peers=sorted(newly))
        return newly

    def adopt(self, dead) -> None:
        """Bump the in-memory generation with `dead` adopted (one
        takeover).  The caller must publish the new map on its next
        stamped commit — until then the adoption is volatile and a
        restart re-detects + redoes it, which is the exactly-once
        shape the daemon's backfill relies on."""
        from paimon_tpu_torch.metrics import MULTIHOST_MAINTENANCE_TAKEOVERS
        before = self.ownership
        self.ownership = before.with_dead(dead)
        if self.ownership is not before:
            self.history = self.history.with_map(self.ownership)
            self._metrics.counter(
                MULTIHOST_MAINTENANCE_TAKEOVERS).inc()
            self._update_owned_gauge()
            self._update_generation_gauge()
            from paimon_tpu_torch.obs.flight import EV_TAKEOVER, record
            record(EV_TAKEOVER, survivor=self.process_index,
                   dead=sorted(self.ownership.dead),
                   generation=self.ownership.version)

    def detect_and_take_over(self, now_ms: Optional[int] = None,
                             refresh: bool = True) -> FrozenSet[int]:
        """Detector + immediate adoption, for standalone maintenance
        loops (no offset backfill to synchronize with): declare peers
        past the timeout dead and bump the in-memory generation; the
        new map rides the next stamped commit.  Deterministic: every
        survivor computes the same verdict and the same successor map
        from store state alone."""
        newly = self.detect_expired(now_ms, refresh)
        if newly and self.takeover_enabled:
            from paimon_tpu_torch.obs.trace import (
                current_context_token, span,
            )
            with span("maintenance.takeover", cat="maintenance",
                      detector=self.process_index, dead=sorted(newly)):
                self.adopt(newly)
                self._takeover_ctx = current_context_token()
        return newly

    # -- coordinated rejoin --------------------------------------------------

    def request_rejoin(self) -> Optional[int]:
        """Publish (or refresh) this dead-recorded host's rejoin
        request: a forced empty snapshot stamping
        `multihost.rejoin.request.p<i>` PLUS the usual lease renewal,
        so the request's liveness rides the requester's own lease —
        a rejoiner that dies again goes stale with its lease and is
        never readmitted from a stale ask.  Returns the snapshot id,
        or None when this plane is not in the rejoining state."""
        if not self.rejoining:
            return None
        props = rejoin_request_props(self.process_index, self._clock())
        sid = self._file_store_commit().commit(
            [], properties=props, force_create=True)
        self.note_renewal()
        return sid

    def pending_rejoin_requests(self) -> FrozenSet[int]:
        """Dead-recorded peers asking to rejoin whose lease is FRESH
        (their request commit renews it, so a live rejoiner keeps its
        ask actionable and a re-dead one ages out).  Detector input is
        pure store state, like death: every survivor computes the
        same set."""
        if self.process_count <= 1 or not self.ownership.dead:
            return frozenset()
        self.refresh_view()
        reqs = merge_rejoin_requests(self.table, self.lease_walk)
        now = self._clock()
        return frozenset(
            p for p in reqs
            if p != self.process_index
            and p in self.ownership.dead
            and self.lease_age_ms(p, now) <= self.lease_timeout_ms)

    def owns_rejoin_grant(self) -> bool:
        """Readmission is table-global like expiry: the lowest-ranked
        ALIVE process grants it, so the granter role itself fails
        over deterministically."""
        return self.owns_expiry()

    def readmit(self, returning) -> FrozenSet[int]:
        """Bump the in-memory generation with `returning` back ALIVE
        (the granter side of rejoin).  The salted-crc32 map hands the
        returner exactly its old primary groups back — warm SSD-tier
        state by construction.  Returns the set actually readmitted
        (exactly-once: a peer not currently dead is a no-op, so a
        granter retrying after a CAS loss cannot double-count).  As
        with `adopt`, the new generation is volatile until the caller
        publishes it on a stamped commit — the stream daemon rides it
        on the same forced commit as its rejoin floor."""
        from paimon_tpu_torch.metrics import FLEET_REJOINS
        returning = frozenset(returning) & frozenset(self.ownership.dead)
        if not returning:
            return frozenset()
        self.ownership = self.ownership.without_dead(returning)
        self.history = self.history.with_map(self.ownership)
        self._declared -= set(returning)
        self._fleet.counter(FLEET_REJOINS).inc(len(returning))
        self._update_owned_gauge()
        self._update_generation_gauge()
        from paimon_tpu_torch.obs.flight import EV_REJOIN_GRANT, record
        record(EV_REJOIN_GRANT, granter=self.process_index,
               returning=sorted(returning),
               generation=self.ownership.version)
        return returning

    # -- heartbeats ----------------------------------------------------------

    def _file_store_commit(self):
        if self._commit is None:
            from paimon_tpu_torch.core.commit import FileStoreCommit
            self._commit = FileStoreCommit(
                self.table.file_io, self.table.path, self.table.schema,
                self.table.options, commit_user=self.commit_user,
                branch=self.table.branch)
            self.attach(self._commit)
        return self._commit

    def heartbeat_due(self, now_ms: Optional[int] = None) -> bool:
        if self.process_count <= 1:
            return False          # nobody is watching the lease
        now = self._clock() if now_ms is None else now_ms
        last = self._view.get(self.process_index, 0)
        return now - last >= self.lease_interval_ms

    def maybe_heartbeat(self, now_ms: Optional[int] = None
                        ) -> Optional[int]:
        """Publish a forced empty snapshot carrying the lease/ownership
        stamps when no plane commit renewed the lease within
        multihost.lease.interval.  Returns the snapshot id, or None
        when no heartbeat was due.  Heartbeats deliberately carry NO
        stream offset property, so checkpoint-offset audits and
        recovery walks skip them."""
        if not self.heartbeat_due(now_ms):
            return None
        sid = self._file_store_commit().commit([], force_create=True)
        self.note_renewal()
        return sid

    def ensure_lease(self) -> Optional[int]:
        """Initial renewal at plane bring-up: peers' failure detectors
        must see a lease before the construction grace runs out."""
        if self.process_count <= 1:
            return None
        sid = self._file_store_commit().commit([], force_create=True)
        self.note_renewal()
        return sid
