"""Distributed write plane: sharded bucket ownership, commit
arbitration, snapshot-consistent cross-host scans, online rescale.

Counterpart of paimon_tpu/parallel/distributed.py over
torch.distributed (parallel/multihost.py: one gloo group, one card a
process).  The reference scales writers across an engine cluster with a
committer-operator singleton serializing snapshot publication
(FileStoreCommit CAS); this module partitions ownership so that hosts'
writers never contend:

- **Ownership** (`OwnershipMap`): every (partition, bucket) is owned by
  exactly one process, deterministically (crc32 shard of the group's
  identity mod the process count; NOT Python `hash()`, which is salted
  per process).  Owners flush through the per-bucket actor pipeline
  (parallel/write_pipeline.py) on disjoint key ranges.  The map is
  versioned in snapshot properties (`multihost.ownership.*`, the
  reference's keys and encoding, so either package's fleet reads the
  other's tables), so a restarted or late-joining process sees which
  generation the tip was written under.

- **Routing** (`multihost.write.routing`): 'exchange' reroutes rows to
  their owners with one allgather per batch (disjoint input streams),
  'spmd' keeps only owned rows (the identical global batch on every
  process), 'local-only' raises.

- **Commit arbitration** (`multihost.commit.arbitration`): 'cas' has
  every process commit its own messages under a per-process commit
  user, serialized by the snapshot CAS with FileStoreCommit's
  optimistic retry (observed through `conflict_listener` into the
  multihost metric group); 'coordinator' gathers every process's commit
  messages to an elected committer, which publishes ONE snapshot per
  global checkpoint.  Both end in a barrier, so after `commit()` every
  process sees every peer's rows.

- **Pinned scans** (`pinned_scan_plan`): the processes agree on one
  snapshot id by a small broadcast, plan against it and read their
  byte-balanced `assign_splits` share.

- **Online rescale** (`rescale_buckets`): drain and hand off.  Every
  writer drains under the OLD layout, each process rewrites the new
  buckets it will own (routing on a one-lane mesh of its own card,
  parallel/rescale.py), the elected committer publishes one overwrite,
  and every writer reopens under the bumped map.

Everything degrades to one process: ownership collapses to process 0,
routing is a no-op, arbitration is a plain commit, and the barriers
return without a collective.
"""

from __future__ import annotations

import pickle
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.parallel import multihost as MH
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

__all__ = ["OwnershipMap", "OwnershipError", "DistributedWritePlane",
           "GenerationHistory", "owner_of", "pinned_scan_plan",
           "OWNERSHIP_VERSION_PROP", "OWNERSHIP_PROCESSES_PROP",
           "OWNERSHIP_BUCKETS_PROP", "OWNERSHIP_DEAD_PROP",
           "OWNERSHIP_HISTORY_PROP",
           "REJOIN_REQUEST_PREFIX", "REJOIN_FLOOR_PREFIX",
           "LEASE_PROP_PREFIX", "lease_props", "merge_lease_view",
           "resume_generation_history", "stamp_from_properties",
           "has_ownership_stamp", "rejoin_request_props",
           "merge_rejoin_requests", "rejoin_floor_props",
           "merge_rejoin_floors"]

# snapshot property keys carrying the ownership-map generation: every
# distributed commit stamps them, so the table's tip records which map
# its files were routed under (rescale bumps the version).  The
# maintenance plane (parallel/maintenance_plane.py) adds two more
# planes of properties on the SAME commits:
#   multihost.ownership.dead   csv of process ids whose buckets have
#                              been taken over by survivors (monotone
#                              within one topology generation)
#   multihost.lease.p<i>       wall-clock ms of process i's last lease
#                              renewal as known by the committer — a
#                              max-merge CRDT: readers fold the last
#                              few snapshots so concurrent committers
#                              cannot regress each other's renewals
OWNERSHIP_VERSION_PROP = "multihost.ownership.version"
OWNERSHIP_PROCESSES_PROP = "multihost.ownership.processes"
OWNERSHIP_BUCKETS_PROP = "multihost.ownership.buckets"
OWNERSHIP_DEAD_PROP = "multihost.ownership.dead"
# the FULL generation chain (version -> processes/buckets/dead-set),
# compactly encoded (see GenerationHistory): chained takeovers and
# rejoins need the map that actually GOVERNED a dead peer's writes,
# which the flat current-generation properties above cannot answer
OWNERSHIP_HISTORY_PROP = "multihost.ownership.history"
# rejoin protocol properties: a resurrected host that finds itself in
# the recorded dead set publishes `...request.p<i> -> wall-clock ms`
# (its lease renews on the same commit, proving it is actually up);
# each alive survivor grants `...floor.p<i> -> "<version>:<granter>:
# <offset>"` once it has flushed everything it ever wrote into the
# rejoiner's groups, bounding the rejoiner's gap replay
REJOIN_REQUEST_PREFIX = "multihost.rejoin.request.p"
REJOIN_FLOOR_PREFIX = "multihost.rejoin.floor.p"
LEASE_PROP_PREFIX = "multihost.lease.p"

# generations are rare (one per takeover / rejoin / rescale); cap how
# many the history property carries so the stamp stays O(1) per commit
_HISTORY_CAP = 64

_ROUTINGS = ("exchange", "spmd", "local-only")
_ARBITRATIONS = ("cas", "coordinator")


class OwnershipError(RuntimeError):
    """A row reached a process that does not own its bucket (routing
    'local-only'), or peers disagree on the write-plane topology."""


def _python_value(v):
    """A partition value as the Python value its repr is keyed on: a
    numpy or torch scalar's repr differs from its value's (numpy 2 gives
    'np.int64(3)'), which would move the group to another owner."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        return v.item()
    return v


def owner_of(partition: Tuple, bucket: int, process_count: int,
             dead: frozenset = frozenset()) -> int:
    """Deterministic owner of (partition, bucket): a crc32 shard over
    the group identity.  crc32, NOT `hash()` — Python string hashing
    is salted per process, and every process must compute the SAME
    map.  repr() of partition values (str/int/date/...) is stable
    across processes for the types partitions can hold; numpy and torch
    scalars count as their Python values.

    `dead` processes own nothing: a group whose primary owner is dead
    is re-sharded (same crc32, re-salted) over the SURVIVORS in rank
    order — every survivor computes the identical takeover map from
    the store-recorded dead set alone, with no communication (the
    dead peer cannot join a collective)."""
    if process_count <= 1:
        return 0
    key = repr((tuple(_python_value(v) for v in partition),
                int(bucket))).encode("utf-8")
    primary = zlib.crc32(key) % process_count
    if primary not in dead:
        return primary
    survivors = [p for p in range(process_count) if p not in dead]
    if not survivors:
        raise OwnershipError(
            "every process of the topology is recorded dead; the "
            "table needs a fresh plane bring-up (new generation)")
    return survivors[zlib.crc32(key + b"#takeover") % len(survivors)]


@dataclass(frozen=True)
class OwnershipMap:
    """One generation of the sharded write-ownership function.

    `dead` is the set of processes whose lease expired and whose
    buckets survivors have adopted: they own nothing until they
    rejoin (which is a new generation — the version bumps whenever
    the ownership FUNCTION changes, takeover included)."""
    version: int
    num_processes: int
    num_buckets: int
    dead: frozenset = frozenset()

    def owner_of(self, partition: Tuple, bucket: int) -> int:
        return owner_of(partition, bucket, self.num_processes,
                        self.dead)

    def alive(self) -> List[int]:
        return [p for p in range(self.num_processes)
                if p not in self.dead]

    def with_dead(self, dead) -> "OwnershipMap":
        """The takeover generation: same topology, `dead` added to
        the dead set, version bumped (a different ownership function
        must never share a version number)."""
        merged = frozenset(self.dead) | frozenset(dead)
        if merged == frozenset(self.dead):
            return self
        return OwnershipMap(self.version + 1, self.num_processes,
                            self.num_buckets, merged)

    def without_dead(self, returning) -> "OwnershipMap":
        """The rejoin generation: same topology, `returning` removed
        from the dead set, version bumped.  Because ownership is the
        pure crc32 shard, readmitting a host hands it back EXACTLY its
        old primary groups (a group re-shards only while its primary
        is dead) — the warm-rejoin property: SSD-tier SSTs/blocks and
        plan-cache state built for those groups are valid again."""
        remaining = frozenset(self.dead) - frozenset(returning)
        if remaining == frozenset(self.dead):
            return self
        return OwnershipMap(self.version + 1, self.num_processes,
                            self.num_buckets, remaining)

    def owned_groups(self, process_index: int, partitions=((),)
                     ) -> List[Tuple[Tuple, int]]:
        """Every (partition, bucket) this process owns, for the given
        partition universe (default: the unpartitioned table)."""
        return [(part, b) for part in partitions
                for b in range(self.num_buckets)
                if self.owner_of(part, b) == process_index]

    def to_properties(self) -> Dict[str, str]:
        props = {OWNERSHIP_VERSION_PROP: str(self.version),
                 OWNERSHIP_PROCESSES_PROP: str(self.num_processes),
                 OWNERSHIP_BUCKETS_PROP: str(self.num_buckets)}
        if self.dead:
            props[OWNERSHIP_DEAD_PROP] = ",".join(
                str(p) for p in sorted(self.dead))
        return props

    def handoffs_to(self, other: "OwnershipMap") -> int:
        """How many non-partitioned bucket owners move between this
        map and `other` (new buckets count as handoffs — they start
        owned by somebody).  Feeds the ownership_handoffs counter."""
        moved = 0
        for b in range(other.num_buckets):
            if b >= self.num_buckets:
                moved += 1
            elif self.owner_of((), b) != other.owner_of((), b):
                moved += 1
        return moved


def _map_from_properties(props: Dict[str, str]) -> OwnershipMap:
    dead = frozenset(
        int(p) for p in (props.get(OWNERSHIP_DEAD_PROP) or "").split(",")
        if p.strip())
    return OwnershipMap(
        int(props[OWNERSHIP_VERSION_PROP]),
        int(props.get(OWNERSHIP_PROCESSES_PROP) or 0),
        int(props.get(OWNERSHIP_BUCKETS_PROP) or 0), dead)


@dataclass(frozen=True)
class GenerationHistory:
    """The full ownership-generation chain, ascending by version.

    The flat `multihost.ownership.*` properties record only the
    CURRENT generation; chained multi-death takeovers and rejoins need
    the map that actually governed a given peer's writes — before this
    existed, floor evaluation approximated it with `current dead -
    {j}`, which is wrong the moment two deaths share one adoption
    round or a host dies, rejoins and dies again.  The history makes
    `owner_of` at any retained version EXACT.

    Encoding (`to_property`): entries `version:processes:buckets:
    dead0+dead1` joined by `|` — e.g. `1:3:4:|2:3:4:2|3:3:4:1+2`.
    Newest `_HISTORY_CAP` generations retained."""

    entries: Tuple[OwnershipMap, ...]

    @staticmethod
    def initial(m: OwnershipMap) -> "GenerationHistory":
        return GenerationHistory((m,))

    def current(self) -> OwnershipMap:
        return self.entries[-1]

    def at(self, version: int) -> Optional[OwnershipMap]:
        """The exact map of one historical generation (None when the
        version predates the retained window)."""
        for m in reversed(self.entries):
            if m.version == version:
                return m
        return None

    def with_map(self, m: OwnershipMap) -> "GenerationHistory":
        """Append a new generation (same map/version is a no-op; a
        version at or below the tip replaces nothing — the caller
        publishes monotone generations)."""
        if self.entries and m == self.entries[-1]:
            return self
        kept = tuple(e for e in self.entries if e.version < m.version)
        return GenerationHistory((kept + (m,))[-_HISTORY_CAP:])

    def map_governing(self, j: int) -> Optional[OwnershipMap]:
        """The map that governed process j's OWN writes: the newest
        retained generation in which j was alive.  None when j is dead
        in every retained entry (history truncation) — callers fall
        back to the legacy `current dead - {j}` approximation."""
        for m in reversed(self.entries):
            if j not in m.dead and j < m.num_processes:
                return m
        return None

    def to_property(self) -> str:
        return "|".join(
            f"{m.version}:{m.num_processes}:{m.num_buckets}:"
            + "+".join(str(p) for p in sorted(m.dead))
            for m in self.entries)

    @staticmethod
    def from_property(raw: str) -> Optional["GenerationHistory"]:
        entries = []
        try:
            for part in raw.split("|"):
                if not part:
                    continue
                v, n, b, dead = part.split(":")
                entries.append(OwnershipMap(
                    int(v), int(n), int(b),
                    frozenset(int(p) for p in dead.split("+") if p)))
        except ValueError:
            return None
        if not entries:
            return None
        entries.sort(key=lambda m: m.version)
        return GenerationHistory(tuple(entries))

    def to_properties(self) -> Dict[str, str]:
        """The full ownership stamp: the current generation's flat
        properties plus the encoded chain — what every plane-issued
        commit carries."""
        props = self.current().to_properties()
        props[OWNERSHIP_HISTORY_PROP] = self.to_property()
        return props


def stamp_from_properties(props: Dict[str, str]
                          ) -> Optional[Tuple[OwnershipMap,
                                              GenerationHistory]]:
    """THE sanctioned read path for ownership stamps: (current map,
    generation history) from one snapshot's properties, or None when
    the snapshot is unstamped.  A stamp without the history property
    (legacy chain prefix) yields a single-entry history.  Every module
    outside this plane parses stamps through here (maintenance/fsck.py,
    the stream daemon's recovery, the CLI's fleet view)."""
    if OWNERSHIP_VERSION_PROP not in (props or {}):
        return None
    m = _map_from_properties(props)
    hist = None
    raw = props.get(OWNERSHIP_HISTORY_PROP)
    if raw:
        hist = GenerationHistory.from_property(raw)
    if hist is None or hist.current().version < m.version:
        hist = GenerationHistory.initial(m) if hist is None \
            else hist.with_map(m)
    return m, hist


def has_ownership_stamp(props: Optional[Dict[str, str]]) -> bool:
    """Whether a snapshot carries an ownership-generation stamp (the
    presence test recovery walks use)."""
    return bool(props) and OWNERSHIP_VERSION_PROP in props


def resume_ownership_map(table, max_walk: int = 64
                         ) -> Optional[OwnershipMap]:
    """The ownership map recorded at the table's tip: walk snapshots
    newest-first for the properties.  Every PLANE-issued commit —
    writes, compactions, heartbeats, the rescale overwrite AND the
    empty-rescale stamp — carries them (core/commit.py
    properties_provider), so under plane-only traffic the TIP itself
    is stamped and the walk is one snapshot deep; the bound only
    matters when foreign commit users (ad-hoc batch writers, repair
    tools) interleave.  If the bounded walk finds nothing but the
    chain continues, keep walking to the earliest snapshot rather
    than inventing a fresh generation: before this fix a long run of
    maintenance-only commits under other commit users pushed the last
    stamped snapshot past the 64-snapshot window and the plane
    restarted at version 1 — one version number denoting two
    different ownership functions.  None only when NO retained
    snapshot carries the properties."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    if latest is None:
        return None
    earliest = sm.earliest_snapshot_id() or latest
    for sid in range(latest, earliest - 1, -1):
        if not sm.snapshot_exists(sid):
            continue
        props = sm.snapshot(sid).properties or {}
        if OWNERSHIP_VERSION_PROP in props:
            return _map_from_properties(props)
    return None


def resume_generation_history(table, max_walk: int = 64
                              ) -> Optional[GenerationHistory]:
    """The generation history recorded at the table's tip: same walk
    discipline as resume_ownership_map (bounded newest-first, then on
    to the earliest rather than inventing a generation).  A stamped
    tip without the history property (chain written before the
    history existed) yields a single-entry history seeded from the
    flat map."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    if latest is None:
        return None
    earliest = sm.earliest_snapshot_id() or latest
    for sid in range(latest, earliest - 1, -1):
        if not sm.snapshot_exists(sid):
            continue
        stamp = stamp_from_properties(sm.snapshot(sid).properties or {})
        if stamp is not None:
            return stamp[1]
    return None


def lease_props(process_index: int, now_ms: int,
                view: Optional[Dict[int, int]] = None
                ) -> Dict[str, str]:
    """The lease properties one commit stamps: the committer's view of
    every holder's last renewal, with its OWN entry renewed to
    `now_ms`.  Committing the full known view (not just self) makes
    the tip a usable failure-detector input on its own."""
    merged = dict(view or {})
    merged[process_index] = max(now_ms,
                                merged.get(process_index, 0))
    return {f"{LEASE_PROP_PREFIX}{p}": str(ms)
            for p, ms in sorted(merged.items())}


def merge_lease_view(table, max_walk: int = 16) -> Dict[int, int]:
    """{process -> newest known lease-renewal ms}: max-merge the lease
    properties of the last `max_walk` snapshots.  Folding a small
    window (not just the tip) keeps concurrent committers from
    regressing each other — each stamps the view IT knew, and the
    interleaving is resolved by max()."""
    from paimon_tpu_torch.obs.trace import (
        STAGE_LEASE_FOLD, span, tracing_enabled,
    )
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    if latest is None:
        return {}
    earliest = sm.earliest_snapshot_id() or latest
    view: Dict[int, int] = {}
    link_ctx = link_sid = None
    for sid in range(latest, max(earliest, latest - max_walk) - 1, -1):
        if not sm.snapshot_exists(sid):
            continue
        props = sm.snapshot(sid).properties or {}
        if link_ctx is None and props.get("trace.context"):
            # newest store-carried context in the fold window: the
            # detector's fold links back to the peer whose commit it
            # consumed — THE worker<->worker boundary in merged traces
            link_ctx, link_sid = props["trace.context"], sid
        for k, v in props.items():
            if not k.startswith(LEASE_PROP_PREFIX):
                continue
            try:
                p, ms = int(k[len(LEASE_PROP_PREFIX):]), int(v)
            except ValueError:
                continue
            if ms > view.get(p, -1):
                view[p] = ms
    if link_ctx is not None and tracing_enabled():
        with span(STAGE_LEASE_FOLD, cat="maintenance", link=link_ctx,
                  snapshot=link_sid):
            pass
    return view


def rejoin_request_props(process_index: int, now_ms: int
                         ) -> Dict[str, str]:
    """The property a refused resurrected host stamps to ask the
    elected survivor for readmission."""
    return {f"{REJOIN_REQUEST_PREFIX}{process_index}": str(now_ms)}


def merge_rejoin_requests(table, max_walk: int = 32) -> Dict[int, int]:
    """{process -> newest rejoin-request ms} max-merged over the last
    `max_walk` snapshots — same window discipline as the lease view.
    The caller decides liveness: a request is actionable only while
    the requester's LEASE is also fresh (the request commit renews it),
    so a host that requested, was readmitted, and died again never
    re-triggers a grant from its stale request."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    if latest is None:
        return {}
    earliest = sm.earliest_snapshot_id() or latest
    out: Dict[int, int] = {}
    for sid in range(latest, max(earliest, latest - max_walk) - 1, -1):
        if not sm.snapshot_exists(sid):
            continue
        props = sm.snapshot(sid).properties or {}
        for k, v in props.items():
            if not k.startswith(REJOIN_REQUEST_PREFIX):
                continue
            try:
                p, ms = int(k[len(REJOIN_REQUEST_PREFIX):]), int(v)
            except ValueError:
                continue
            if ms > out.get(p, -1):
                out[p] = ms
    return out


def rejoin_floor_props(granter: int, rejoiner: int, version: int,
                       offset: int) -> Dict[str, str]:
    """The coverage floor one survivor grants a rejoiner: 'everything
    I ever wrote into your groups is committed and ends at `offset`',
    scoped to the readmission generation `version` so floors from an
    earlier rejoin of the same process can never be mistaken for this
    one's."""
    return {f"{REJOIN_FLOOR_PREFIX}{rejoiner}":
            f"{version}:{granter}:{offset}"}


def merge_rejoin_floors(table, rejoiner: int, version: int,
                        max_walk: int = 32) -> Dict[int, int]:
    """{granter -> offset} of every rejoin floor stamped for
    `rejoiner` at readmission generation `version` OR LATER, folded
    over the last `max_walk` snapshots (each snapshot is one
    committer's stamp; the fold collects the cohort's).  Later
    versions count because a survivor may only notice the readmission
    after yet another generation bump — its floor is stamped at its
    then-current offset, still a valid upper bound on what it ever
    wrote into the rejoiner's groups.  Floors from an EARLIER rejoin
    epoch of the same process stay excluded."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    if latest is None:
        return {}
    earliest = sm.earliest_snapshot_id() or latest
    key = f"{REJOIN_FLOOR_PREFIX}{rejoiner}"
    out: Dict[int, int] = {}
    for sid in range(latest, max(earliest, latest - max_walk) - 1, -1):
        if not sm.snapshot_exists(sid):
            continue
        raw = (sm.snapshot(sid).properties or {}).get(key)
        if not raw:
            continue
        try:
            v, granter, offset = (int(x) for x in raw.split(":"))
        except ValueError:
            continue
        if v >= version and offset > out.get(granter, -(1 << 62)):
            out[granter] = offset
    return out


def resume_ownership_version(table, max_walk: int = 64) -> int:
    """Version-only view of resume_ownership_map (0 = never)."""
    m = resume_ownership_map(table, max_walk)
    return m.version if m is not None else 0


def pinned_scan_plan(table, process_index: Optional[int] = None,
                     process_count: Optional[int] = None):
    """Snapshot-consistent cross-host scan plan: agree on ONE snapshot
    id (process 0's latest, via a small broadcast — unless
    multihost.scan.pin-snapshot=false), plan against it, and return
    (snapshot_id, this process's byte-balanced split share).  Every
    process computes the same global plan; no coordinator hands out
    work.  (None, []) when the table has no snapshot."""
    local = table.snapshot_manager.latest_snapshot_id() or 0
    if table.options.get(CoreOptions.MULTIHOST_SCAN_PIN):
        sid = MH.broadcast_value(local)
    else:
        sid = local
    if sid == 0:
        return None, []
    plan = table.new_read_builder().new_scan().plan(snapshot_id=sid)
    mine = MH.assign_splits(plan.splits, process_index, process_count)
    return sid, mine


def _table_to_ipc(t: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue().to_pybytes()


def _table_from_ipc(b: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.BufferReader(b)) as r:
        return r.read_all()


class DistributedWritePlane:
    """One process's slice of the multi-host write plane over a
    fixed-bucket table.  SPMD contract: every process constructs the
    plane, calls `write_*` the same number of times (routing
    'exchange' runs one collective per batch), and calls `commit` /
    `rescale_buckets` at the same points (the program order of every
    SPMD program).

    Usage (identical on every host):
        plane = table.new_distributed_write()
        plane.write_dicts(my_host_rows)      # routed to owners
        plane.commit()                       # arbitrated publish
        sid, splits = plane.pinned_scan()    # consistent read share
        plane.close()
    """

    def __init__(self, table, base_user: str = "writer",
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 committer_index: int = 0):
        self.table = table
        self.process_index = (MH.process_index()
                              if process_index is None else process_index)
        self.process_count = (MH.process_count()
                              if process_count is None else process_count)
        self.committer_index = committer_index % max(1, self.process_count)
        self.base_user = base_user
        if table.options.bucket < 1:
            raise OwnershipError(
                "distributed writes need a fixed-bucket table "
                f"(bucket={table.options.bucket}): dynamic/postpone "
                "bucket assignment is stateful per process and cannot "
                "be sharded deterministically")
        if not table.schema.primary_keys:
            raise OwnershipError(
                "distributed writes need a primary-key table: the "
                "append writer has no precomputed-bucket route for "
                "the ownership split")
        if table.schema.cross_partition_update():
            raise OwnershipError(
                "distributed writes do not support cross-partition "
                "update tables: the global index that reroutes "
                "partition changes is per-process state")
        self.routing = table.options.get(
            CoreOptions.MULTIHOST_WRITE_ROUTING)
        if self.routing not in _ROUTINGS:
            raise ValueError(f"multihost.write.routing must be one of "
                             f"{_ROUTINGS}, got {self.routing!r}")
        self.arbitration = table.options.get(
            CoreOptions.MULTIHOST_COMMIT_ARBITRATION)
        if self.arbitration not in _ARBITRATIONS:
            raise ValueError(f"multihost.commit.arbitration must be one "
                             f"of {_ARBITRATIONS}, got "
                             f"{self.arbitration!r}")
        from paimon_tpu_torch.metrics import (
            MULTIHOST_BARRIER_WAIT_MS, MULTIHOST_COMMIT_CONFLICTS,
            MULTIHOST_COMMIT_RETRIES, MULTIHOST_CONFIG_WARNINGS,
            MULTIHOST_FOREIGN_ROWS, MULTIHOST_OWNERSHIP_HANDOFFS,
            global_registry,
        )
        self._metrics = global_registry().multihost_metrics()
        # pre-allocate the group's series so dashboards and the
        # Prometheus endpoint always expose them (a conflict-free run
        # must render commit_conflicts 0, not omit the series)
        for c in (MULTIHOST_COMMIT_CONFLICTS, MULTIHOST_COMMIT_RETRIES,
                  MULTIHOST_OWNERSHIP_HANDOFFS, MULTIHOST_FOREIGN_ROWS,
                  MULTIHOST_CONFIG_WARNINGS):
            self._metrics.counter(c)
        self._metrics.histogram(MULTIHOST_BARRIER_WAIT_MS)
        # dynamic (load-time) options are NOT in the on-disk schema;
        # remember them so the rescale handoff's table reload can
        # re-apply them (copy() REPLACES dynamic options, and silently
        # losing write-only / retry tuning mid-run is a footgun)
        base_opts = table.schema_manager.latest().options
        self._dynamic_opts = {
            k: v for k, v in table.options.to_map().items()
            if base_opts.get(k) != v}
        recorded_history = resume_generation_history(table)
        recorded = recorded_history.current() \
            if recorded_history is not None else None
        buckets = table.options.bucket
        if recorded is None:
            self.ownership = OwnershipMap(1, self.process_count,
                                          buckets)
        elif (recorded.num_processes, recorded.num_buckets) == \
                (self.process_count, buckets) and not recorded.dead:
            self.ownership = OwnershipMap(recorded.version,
                                          self.process_count, buckets)
        else:
            # the topology changed without a coordinated rescale (a
            # resized cluster, a legacy tip without the full
            # properties, or a recorded DEAD set — the full write
            # cohort standing up again is a rejoin): that IS a new
            # ownership function — reusing the recorded version would
            # let one number denote two different maps.  Bump the
            # generation and account the moved owners.
            self.ownership = OwnershipMap(recorded.version + 1,
                                          self.process_count, buckets)
            if recorded.num_processes and recorded.num_buckets:
                from paimon_tpu_torch.metrics import (
                    MULTIHOST_OWNERSHIP_HANDOFFS,
                )
                moved = recorded.handoffs_to(self.ownership)
                if moved:
                    self._metrics.counter(
                        MULTIHOST_OWNERSHIP_HANDOFFS).inc(moved)
        self.history = (recorded_history
                        or GenerationHistory.initial(self.ownership)
                        ).with_map(self.ownership)
        self._had_conflict = False
        self._closed = False
        # introspection: which new buckets THIS host rewrote in the
        # most recent rescale (the distributed-rescale tests assert
        # the share stays within the host's owned set)
        self.last_rescale_written_buckets: List[int] = []
        self._open_writer()

    # -- wiring --------------------------------------------------------------

    @property
    def commit_user(self) -> str:
        """Per-process under 'cas' (the CAS serializes N users); ONE
        stable committer user under 'coordinator' (exactly-once replay
        dedup keys on it)."""
        if self.arbitration == "coordinator":
            return f"{self.base_user}-committer"
        return f"{self.base_user}-p{self.process_index}"

    def _open_writer(self):
        from paimon_tpu_torch.core.bucket import FixedBucketAssigner
        wb = self.table.new_batch_write_builder()
        wb.commit_user = self.commit_user
        self._write = wb.new_write()
        self._commit = wb.new_commit()
        # commit arbitration IS FileStoreCommit's CAS retry loop;
        # observe its lost races into the multihost group
        self._commit._commit.conflict_listener = self._on_conflict
        schema = self.table.schema
        rt = schema.logical_row_type()
        bucket_keys = schema.bucket_keys() or \
            schema.trimmed_primary_keys()
        self._assigner = FixedBucketAssigner(
            bucket_keys, [rt.get_field(k).type for k in bucket_keys],
            self.table.options.bucket)
        self._partition_keys = schema.partition_keys

    def _on_conflict(self, attempt: int):
        from paimon_tpu_torch.metrics import MULTIHOST_COMMIT_CONFLICTS
        self._metrics.counter(MULTIHOST_COMMIT_CONFLICTS).inc()
        self._had_conflict = True

    # -- writes --------------------------------------------------------------

    def write_dicts(self, rows: Sequence[dict],
                    row_kinds: Optional[Sequence[int]] = None):
        from paimon_tpu_torch.core.write import dicts_to_arrow
        t, kinds = dicts_to_arrow(self.table.arrow_schema(), rows,
                                  row_kinds)
        self.write_arrow(t, kinds)

    def write_arrow(self, data: pa.Table,
                    row_kinds: Optional[np.ndarray] = None):
        """Route a batch: owned rows go straight into the local
        per-bucket actor pipeline; foreign rows are exchanged /
        dropped / rejected per multihost.write.routing.  Routing
        'exchange' is a COLLECTIVE — every process must call
        write_arrow the same number of times, even with empty
        batches."""
        if self._closed:
            raise RuntimeError("write plane is closed")
        from paimon_tpu_torch.core.write import extract_row_kinds
        data, kinds = extract_row_kinds(data, row_kinds)
        # field defaults fill BEFORE the ownership hash: the inner
        # TableWrite applies them after this split, so hashing the
        # pre-default NULLs here would route a defaulted bucket-key
        # row to a different bucket than the single-process path
        # (idempotent — the inner second application sees no NULLs)
        data = self._write._apply_field_defaults(data)
        local_idx, foreign_idx, buckets = self._split_local_foreign(data)
        if self.routing == "local-only" and len(foreign_idx):
            raise OwnershipError(
                f"{len(foreign_idx)} rows hash to buckets owned by "
                f"other processes (routing=local-only); partition the "
                f"input stream by ownership or use routing=exchange")
        if len(local_idx):
            idx = pa.array(local_idx)
            self._write.write_arrow(data.take(idx), kinds[local_idx],
                                    buckets=buckets[local_idx])
        if self.routing == "exchange":
            self._exchange(data, kinds, foreign_idx)

    def _split_local_foreign(self, data: pa.Table):
        """(local_row_indices, foreign_row_indices, bucket[i]) for one
        batch — the ownership split, computed once per batch from the
        same FixedBucketAssigner hash the writers use."""
        from paimon_tpu_torch.core.write import group_by_partition_bucket
        if data.num_rows == 0:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty, np.empty(0, dtype=np.int32)
        buckets = np.asarray(self._assigner.assign(data),
                             dtype=np.int32)
        local: List[np.ndarray] = []
        foreign: List[np.ndarray] = []
        for (part, bucket), idx in group_by_partition_bucket(
                data, buckets, self._partition_keys):
            if self.ownership.owner_of(part, bucket) == \
                    self.process_index:
                local.append(idx)
            else:
                foreign.append(idx)
        cat = (lambda parts: np.sort(np.concatenate(parts))
               if parts else np.empty(0, dtype=np.int64))
        return cat(local), cat(foreign), buckets

    def _exchange(self, data: pa.Table, kinds: np.ndarray,
                  foreign_idx: np.ndarray):
        """Reroute foreign rows to their owners: one padded allgather
        of Arrow-IPC payloads; every process then keeps the rows IT
        owns from every peer's payload.  Runs unconditionally in
        'exchange' mode (collective symmetry — peers with zero foreign
        rows still participate with an empty payload)."""
        from paimon_tpu_torch.core.write import ROW_KIND_COL, extract_row_kinds
        if len(foreign_idx):
            sub = data.take(pa.array(foreign_idx))
            sub = sub.append_column(
                ROW_KIND_COL, pa.array(kinds[foreign_idx], pa.int8()))
        else:
            sub = data.slice(0, 0).append_column(
                ROW_KIND_COL, pa.array([], pa.int8()))
        payloads = MH.allgather_bytes(_table_to_ipc(sub))
        from paimon_tpu_torch.metrics import MULTIHOST_FOREIGN_ROWS
        routed = 0
        for p, payload in enumerate(payloads):
            if p == self.process_index:
                continue          # my own foreign rows went to peers
            recv = _table_from_ipc(payload)
            if recv.num_rows == 0:
                continue
            recv, recv_kinds = extract_row_kinds(recv, None)
            local_idx, _, buckets = self._split_local_foreign(recv)
            if len(local_idx):
                idx = pa.array(local_idx)
                self._write.write_arrow(recv.take(idx),
                                        recv_kinds[local_idx],
                                        buckets=buckets[local_idx])
                routed += len(local_idx)
        if routed:
            self._metrics.counter(MULTIHOST_FOREIGN_ROWS).inc(routed)

    # -- commit arbitration --------------------------------------------------

    def commit(self, commit_identifier: int = BATCH_COMMIT_IDENTIFIER,
               properties: Optional[Dict[str, str]] = None
               ) -> Optional[int]:
        """Arbitrated publish of every process's pending writes; all
        processes return only after every peer's rows are visible
        (barrier).  Returns the latest snapshot id this process
        observed (None when the whole checkpoint was empty)."""
        if self._closed:
            raise RuntimeError("write plane is closed")
        msgs = self._write.prepare_commit()
        props = self.history.to_properties()
        if properties:
            props.update(properties)
        self._had_conflict = False
        if self.arbitration == "coordinator":
            sid = self._commit_coordinator(msgs, commit_identifier,
                                           props)
        else:
            sid = self._commit.commit(msgs, commit_identifier,
                                      properties=props)
            MH.barrier("multihost-commit")
            if sid is None:
                sid = self.table.snapshot_manager.latest_snapshot_id()
        if self._had_conflict:
            from paimon_tpu_torch.metrics import MULTIHOST_COMMIT_RETRIES
            self._metrics.counter(MULTIHOST_COMMIT_RETRIES).inc()
        return sid

    def _commit_coordinator(self, msgs, commit_identifier, props
                            ) -> Optional[int]:
        """Elected-committer arbitration: gather every process's
        commit messages over the mesh, the committer publishes ONE
        snapshot per global checkpoint, everyone barriers on the
        result (reference committer-operator singleton).  The wire is
        pickle over the padded allgather — trusted same-binary
        processes of one mesh, never external input."""
        payloads = MH.allgather_bytes(pickle.dumps(list(msgs)))
        sid = None
        if self.process_index == self.committer_index:
            all_msgs = [m for pl in payloads for m in pickle.loads(pl)]
            sid = self._commit.commit(all_msgs, commit_identifier,
                                      properties=props)
        MH.barrier("multihost-commit")
        if sid is None:
            sid = self.table.snapshot_manager.latest_snapshot_id()
        return sid

    def filter_committed(self, identifiers: Sequence[int]) -> List[int]:
        """Exactly-once replay dedup against this plane's commit user
        (coordinator: the shared committer user)."""
        return self._commit.filter_committed(identifiers)

    # -- scans ---------------------------------------------------------------

    def pinned_scan(self):
        """(snapshot_id, my split share) — see pinned_scan_plan."""
        return pinned_scan_plan(self.table, self.process_index,
                                self.process_count)

    def scan_to_arrow(self) -> pa.Table:
        """Read this process's pinned split share as one Arrow table
        (empty table with the right schema when nothing is owned)."""
        sid, splits = self.pinned_scan()
        read = self.table.new_read_builder().new_read()
        tables = [read.read_split(s) for s in splits]
        if not tables:
            return self.table.arrow_schema().empty_table()
        return pa.concat_tables(tables, promote_options="none")

    # -- online rescale ------------------------------------------------------

    def rescale_buckets(self, new_buckets: int) -> Optional[int]:
        """Change the bucket count under live write traffic:
        drain-and-handoff.  Every process drains and publishes its
        pending rows under the OLD ownership map (arbitrated commit =
        barrier included), the elected process rewrites the table to
        `new_buckets` (parallel/rescale.py), a barrier publishes the
        handoff, and every process reopens its writers under the NEW
        map (version bumped; moved owners counted as
        ownership_handoffs).  Returns the rescale snapshot id as this
        process observes it."""
        if self._closed:
            raise RuntimeError("write plane is closed")
        # preconditions checked on EVERY process BEFORE any barrier:
        # a committer-only failure would strand the peers inside the
        # barrier, so validation errors raise identically everywhere,
        # with the plane still usable
        if new_buckets < 1:
            raise ValueError(f"new_buckets must be >= 1, got "
                             f"{new_buckets}")
        if self.table.schema.partition_keys:
            raise OwnershipError(
                "rescale of partitioned tables is per-partition and "
                "not supported by the distributed plane")
        # 1. drain: nothing written under the old layout may still be
        # buffered when the layout changes
        self.commit()
        old_map = self.ownership
        new_map = OwnershipMap(old_map.version + 1, self.process_count,
                               new_buckets)
        new_history = self.history.with_map(new_map)
        # an EMPTY drained table has nothing to rewrite —
        # rescale_table_buckets would no-op WITHOUT the schema change
        # and every process would then fail the post-handoff bucket
        # check; the rescale of an empty table is just the schema
        # change.  Every process reads the same post-drain tip (the
        # commit barrier ordered all drains before this), so the
        # branch is deterministic across the mesh.
        tip = self.table.snapshot_manager.latest_snapshot()
        empty = tip is None or tip.total_record_count == 0
        # 2. the rewrite.  On a real multi-process group every process
        # rewrites only the new buckets it will OWN under the bumped
        # map: each reads the same drained tip, routes the rows on a
        # one-lane mesh of its own card (a group-wide routing program
        # issued by one process would desynchronize the peers'
        # collective streams), writes its owned buckets' files, and
        # ships the commit messages to the elected committer over the
        # allgather.  Fake topologies (explicit process_index/count
        # inside one real process, where the allgather degrades to
        # [self]) keep the elected full rewrite: sharding there would
        # drop the other fake processes' buckets.  The overwrite
        # snapshot carries the NEW map's version properties, so a
        # process restarting between the rescale and the first
        # post-rescale commit resumes the bumped generation
        from paimon_tpu_torch.parallel.sharded_merge import BucketMesh
        sharded_rewrite = (not empty and self.process_count > 1
                           and MH.process_count() == self.process_count)
        self.last_rescale_written_buckets: List[int] = []
        local = BucketMesh(1, self.table.device)
        if empty:
            if self.process_index == self.committer_index:
                from paimon_tpu_torch.schema import (
                    SchemaChange, SchemaManager,
                )
                SchemaManager(
                    self.table.file_io, self.table.path,
                    self.table.branch).commit_changes(
                        SchemaChange.set_option("bucket",
                                                str(new_buckets)))
        elif sharded_rewrite:
            from paimon_tpu_torch.parallel.rescale import (
                rescale_commit, rescale_routing, rescale_write_messages,
            )
            values = self.table.to_arrow()
            routing = rescale_routing(self.table, values, new_buckets,
                                      mesh=local)
            mine = [b for b in routing
                    if new_map.owner_of((), int(b))
                    == self.process_index]
            msgs = rescale_write_messages(self.table, values, routing,
                                          new_buckets, buckets=mine)
            self.last_rescale_written_buckets = sorted(
                int(m.bucket) for m in msgs)
            payloads = MH.allgather_bytes(pickle.dumps(list(msgs)))
            if self.process_index == self.committer_index:
                all_msgs = [m for pl in payloads
                            for m in pickle.loads(pl)]
                rescale_commit(self.table, new_buckets, all_msgs,
                               properties=new_history.to_properties())
        elif self.process_index == self.committer_index:
            sid = self.table.rescale_buckets(
                new_buckets, mesh=local,
                properties=new_history.to_properties())
            if sid is not None:
                self.last_rescale_written_buckets = sorted(
                    range(new_buckets))
        MH.barrier("multihost-rescale")
        # 3. handoff: reopen against the new schema generation,
        # re-applying the load-time dynamic options copy() would drop
        # (minus any stale dynamic bucket override — the rescaled
        # schema is authoritative for the bucket count)
        self._write.close()
        dyn = {k: v for k, v in self._dynamic_opts.items()
               if k != "bucket"}
        self.table = self.table.copy(dyn)
        if self.table.options.bucket != new_buckets:
            raise OwnershipError(
                f"rescale handoff: table reports bucket="
                f"{self.table.options.bucket}, expected {new_buckets}")
        self.ownership = new_map
        self.history = new_history
        from paimon_tpu_torch.metrics import MULTIHOST_OWNERSHIP_HANDOFFS
        moved = old_map.handoffs_to(self.ownership)
        if moved:
            self._metrics.counter(MULTIHOST_OWNERSHIP_HANDOFFS).inc(
                moved)
        self._open_writer()
        if empty:
            # the empty branch produced no snapshot to carry the new
            # generation: stamp it with one forced empty snapshot so
            # a restart before the first post-rescale commit still
            # resumes the bumped version (same guarantee as the
            # overwrite branch)
            if self.process_index == self.committer_index:
                self._commit._commit.commit(
                    [], properties=self.history.to_properties(),
                    force_create=True)
            MH.barrier("multihost-rescale-stamp")
        return self.table.snapshot_manager.latest_snapshot_id()

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        if not self._closed:
            self._closed = True
            self._write.close()

    def __enter__(self) -> "DistributedWritePlane":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
