"""Metric registry: counters, gauges and latency histograms by group.

Counterpart of paimon_tpu/metrics.py, reduced to what the ported
planes record: the compaction group's fault counters and window /
fallback histograms, the scan group's device-decode fallbacks and
byte-cache counters, and the serving plane's service, lookup,
resilience and slo groups, the maintenance plane's counters
(maintenance and fleet groups: fsck violations, incremental fsck
sweeps), the read and write planes' retries, prefetch budget and flush
counters (scan and write groups), the host-SSD tier's and the upload
stager's counters (cache_disk group), the hedges and breakers of the
resilience group, the replica router's counters (service group) and the incremental metadata plane (plan group:
plans, delta applies, manifests read and pruned, entries decoded,
sidecar fallbacks, manifest compactions), the stage histograms of the
ported planes (io: read, decode, encode, upload; scan: merge and the
plan's ms; write: sort; commit: CAS and manifest encode, with the commit
group's counters), and the compaction group's task counters with the
busy window of `CompactTimer`.  `snapshot_rows` is the one
serialization behind `snapshot()` and the Prometheus text of
obs/export.py; and the stream daemon's stream group (events, checkpoints
and their ms, loop restarts, freshness, changelog rows, compactions and
pauses, the source backlog); the multi-host planes' multihost group
(commit conflicts and retries, ownership handoffs, barrier waits,
foreign rows routed, config warnings, owned buckets, takeovers, lease
renewals and expiries) and the fleet group's rejoins and generations.

reference: paimon-core/.../metrics/ (MetricRegistry, Counter, Gauge,
Histogram) with groups CommitMetrics / ScanMetrics / CompactionMetrics,
and compact/CompactTimer.java.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricGroup",
           "MetricRegistry", "global_registry", "CompactTimer",
           "COMPACTION_BUCKET_RETRIES", "COMPACTION_BUCKET_FALLBACKS",
           "COMPACTION_BUCKET_FAILURES", "SCAN_DEVICE_DECODE_FALLBACKS",
           "SCAN_FILE_CACHE_HITS", "SCAN_FILE_CACHE_MISSES",
           "SCAN_FOOTER_CACHE_HITS", "SCAN_FOOTER_CACHE_MISSES",
           "SCAN_RANGE_CACHE_HITS", "SCAN_RANGE_CACHE_MISSES",
           "SCAN_RANGE_CACHE_HIT_BYTES",
           "COMPACTION_WINDOW_MS", "COMPACTION_FALLBACK_MS",
           "SERVICE_REQUESTS", "SERVICE_REJECTED",
           "SERVICE_QUEUE_DEPTH", "SERVICE_INFLIGHT_BYTES",
           "SERVICE_TENANT_BYTES", "SERVICE_ADMISSION_WAIT_MS",
           "SERVICE_LOOKUP_MS", "SERVICE_SCAN_MS",
           "SERVICE_CHANGELOG_MS", "SERVICE_LOOKUP_KEYS",
           "SERVICE_LOOKUP_CPU_MS", "SERVICE_LOOP_LAG_MS",
           "SERVICE_CONNECTIONS", "SERVICE_DELTA_ROWS",
           "SERVICE_DELTA_BYTES", "SERVICE_DELTA_OVERFLOWS",
           "SERVICE_SCAN_CACHE_HITS", "SERVICE_SCAN_CACHE_MISSES",
           "LOOKUP_BLOCK_CACHE_HITS", "LOOKUP_BLOCK_CACHE_MISSES",
           "LOOKUP_READER_BUILDS", "LOOKUP_READER_REUSES",
           "LOOKUP_FILES_PRUNED", "LOOKUP_SNAPSHOT_REFRESHES",
           "LOOKUP_DELTA_HITS", "LOOKUP_NATIVE_PROBES",
           "LOOKUP_NATIVE_FALLBACKS", "RESILIENCE_DEADLINE_EXCEEDED",
           "RESILIENCE_BROWNOUT_SHEDS", "RESILIENCE_BROWNOUT_LEVEL",
           "SLO_AVAILABILITY_BURN_FAST", "SLO_AVAILABILITY_BURN_SLOW",
           "SLO_LATENCY_BURN_FAST", "SLO_LATENCY_BURN_SLOW",
           "SLO_ALERT", "SLO_GOOD_EVENTS", "SLO_BAD_EVENTS",
           "FSCK_VIOLATIONS", "PLAN_MANIFEST_COMPACTIONS",
           "FLEET_FSCK_INCREMENTAL_RUNS", "FLEET_FSCK_OBJECTS_CHECKED",
           "FLEET_FSCK_WATERMARK_AGE_MS", "FLEET_REJOINS",
           "FLEET_GENERATIONS", "MULTIHOST_COMMIT_CONFLICTS",
           "MULTIHOST_COMMIT_RETRIES", "MULTIHOST_OWNERSHIP_HANDOFFS",
           "MULTIHOST_BARRIER_WAIT_MS", "MULTIHOST_FOREIGN_ROWS",
           "MULTIHOST_CONFIG_WARNINGS", "MULTIHOST_OWNED_BUCKETS",
           "MULTIHOST_MAINTENANCE_TAKEOVERS", "MULTIHOST_LEASE_RENEWALS",
           "MULTIHOST_LEASE_EXPIRED",
           "SCAN_PIPELINE_SPLITS", "SCAN_PIPELINE_BYTES",
           "SCAN_READ_RETRIES", "SCAN_SPLIT_MS",
           "WRITE_FLUSHES", "WRITE_FLUSHED_BYTES", "WRITE_FLUSH_WAIT_MS",
           "WRITE_INFLIGHT_BYTES", "WRITE_RETRIES", "WRITE_SORT_MS",
           "WRITE_FLUSH_TASK_MS", "CACHE_DISK_STAGED_UPLOADS",
           "CACHE_DISK_HITS", "CACHE_DISK_MISSES", "CACHE_DISK_PROMOTIONS",
           "CACHE_DISK_DEMOTIONS", "CACHE_DISK_EVICTIONS", "CACHE_DISK_BYTES",
           "RESILIENCE_HEDGES_ISSUED", "RESILIENCE_HEDGES_WON",
           "RESILIENCE_HEDGES_ABANDONED", "RESILIENCE_BREAKER_STATE",
           "RESILIENCE_BREAKER_FAST_FAILS", "RESILIENCE_HEDGE_WAIT_MS",
           "SERVICE_ROUTER_FORWARDED", "SERVICE_ROUTER_UPSTREAM_ERRORS",
           "SERVICE_ROUTER_RING_CHANGES",
           "CACHE_DISK_STAGE_MS", "PLAN_PLANS", "PLAN_MS",
           "PLAN_DELTA_APPLIES", "PLAN_MANIFESTS_READ",
           "PLAN_MANIFESTS_PRUNED", "PLAN_ENTRIES_DECODED",
           "PLAN_SIDECAR_FALLBACKS", "SCAN_MERGE_MS", "IO_READ_MS",
           "IO_DECODE_MS", "IO_ENCODE_MS", "IO_UPLOAD_MS",
           "COMMIT_CAS_MS", "COMMIT_MANIFEST_ENCODE_MS",
           "SCAN_DEVICE_DECODE_FILES", "STREAM_EVENTS_INGESTED",
           "STREAM_CHECKPOINTS", "STREAM_CHECKPOINT_MS",
           "STREAM_LOOP_RESTARTS", "STREAM_FRESHNESS_MS",
           "STREAM_CHANGELOG_ROWS", "STREAM_COMPACTIONS",
           "STREAM_COMPACTIONS_PAUSED", "STREAM_SOURCE_BACKLOG"]

# fault-tolerance counters of the compaction group (producer:
# parallel/mesh_engine.py):
#   bucket_retries   — transient per-bucket failures that were retried
#   bucket_fallbacks — buckets degraded to the single-chip path
#   bucket_failures  — buckets that exhausted the whole ladder (raised)
COMPACTION_BUCKET_RETRIES = "bucket_retries"
COMPACTION_BUCKET_FALLBACKS = "bucket_fallbacks"
COMPACTION_BUCKET_FAILURES = "bucket_failures"
# maintenance group: violations found by fsck (maintenance/fsck.py)
FSCK_VIOLATIONS = "fsck_violations"
# plan group (core/scan.py's delta-apply plan cache and vectorised
# manifest pruning; manifest_compactions from
# maintenance/manifest_compact.py).  entries_decoded is the proof meter:
# it must not move for pruned manifests.  sidecar_fallbacks (ours)
# counts manifests a sidecar-enabled scan pruned by the per-meta Python
# check because their list's sidecar was missing or undecodable.
PLAN_PLANS = "plans"                          # scan plans produced
PLAN_MS = "plan_ms"                           # one whole plan() call
PLAN_DELTA_APPLIES = "plan_delta_applies"     # cache-advanced plans
PLAN_MANIFESTS_READ = "manifests_read"        # manifest files fetched
PLAN_MANIFESTS_PRUNED = "manifests_pruned"    # skipped before fetch
PLAN_ENTRIES_DECODED = "entries_decoded"      # manifest entries decoded
PLAN_SIDECAR_FALLBACKS = "sidecar_fallbacks"  # Python-pruned manifests
PLAN_MANIFEST_COMPACTIONS = "manifest_compactions"  # full rewrites
# fleet group (maintenance/fsck.py): fsck sweeps asked to ride the
# watermark, the objects (snapshots, manifests, data files) a sweep
# verified, and the age of the last clean-sweep watermark
FLEET_FSCK_INCREMENTAL_RUNS = "fsck_incremental_runs"
FLEET_FSCK_OBJECTS_CHECKED = "fsck_objects_checked"
FLEET_FSCK_WATERMARK_AGE_MS = "fsck_watermark_age_ms"
# the rest of the fleet group (parallel/maintenance_plane.py): hosts the
# elected granter readmitted, and a gauge of the current ownership-map
# version (every takeover, rejoin and rescale advances it)
FLEET_REJOINS = "rejoins"
FLEET_GENERATIONS = "generations"
# multihost group (parallel/multihost.py, parallel/distributed.py,
# parallel/maintenance_plane.py): snapshot-CAS losses of distributed
# commits, distributed commits that needed more than one CAS attempt,
# (partition, bucket) owners moved between ownership versions, the wall
# time in cross-process barriers, rows exchanged to their owners,
# collective-configuration warnings; the maintenance plane's owned
# groups (a gauge that jumps on a takeover), lease renewals, peers its
# detector declared dead and completed adoptions
MULTIHOST_COMMIT_CONFLICTS = "commit_conflicts"
MULTIHOST_COMMIT_RETRIES = "commit_retries"
MULTIHOST_OWNERSHIP_HANDOFFS = "ownership_handoffs"
MULTIHOST_BARRIER_WAIT_MS = "barrier_wait_ms"
MULTIHOST_FOREIGN_ROWS = "foreign_rows_routed"
MULTIHOST_CONFIG_WARNINGS = "config_warnings"
MULTIHOST_OWNED_BUCKETS = "owned_buckets"
MULTIHOST_MAINTENANCE_TAKEOVERS = "maintenance_takeovers"
MULTIHOST_LEASE_RENEWALS = "lease_renewals"
MULTIHOST_LEASE_EXPIRED = "lease_expired"
# scan group: parquet files the device decode plane streamed, and those
# it handed back to the pyarrow host path
SCAN_DEVICE_DECODE_FILES = "device_decode_files"
SCAN_DEVICE_DECODE_FALLBACKS = "device_decode_fallbacks"
# scan group: the byte and footer caches of fs/caching.py
SCAN_FILE_CACHE_HITS = "file_cache_hits"
SCAN_FILE_CACHE_MISSES = "file_cache_misses"
SCAN_FOOTER_CACHE_HITS = "footer_cache_hits"
SCAN_FOOTER_CACHE_MISSES = "footer_cache_misses"
SCAN_RANGE_CACHE_HITS = "range_cache_hits"
SCAN_RANGE_CACHE_MISSES = "range_cache_misses"
SCAN_RANGE_CACHE_HIT_BYTES = "range_cache_hit_bytes"
# scan group: the pipelined scan (parallel/scan_pipeline.py)
SCAN_PIPELINE_SPLITS = "pipeline_splits"          # splits prefetched
SCAN_PIPELINE_BYTES = "pipeline_bytes"            # est. bytes admitted
SCAN_READ_RETRIES = "read_retries"                # transient IO retries
# write group: the pipelined write (parallel/write_pipeline.py)
WRITE_FLUSHES = "flushes"                   # flush tasks admitted
WRITE_FLUSHED_BYTES = "flushed_bytes"       # est. buffered bytes flushed
WRITE_FLUSH_WAIT_MS = "flush_wait_ms"       # producer ms blocked on the
                                            # in-flight byte budget
WRITE_INFLIGHT_BYTES = "inflight_bytes"     # gauge: bytes in flight now
WRITE_RETRIES = "write_retries"             # transient flush retries
# cache_disk group: the host-SSD read tier (fs/caching.py DiskCacheTier;
# promotions are hit-earned memory->disk writes, demotions entries
# pushed to disk by memory pressure, evictions disk entries dropped by
# the max-bytes bound or failed validation) and the write path's staged
# uploads (UploadStager)
CACHE_DISK_HITS = "hits"                      # served from SSD
CACHE_DISK_MISSES = "misses"                  # disk tier consulted, absent
CACHE_DISK_PROMOTIONS = "promotions"          # hit-earned mem->disk writes
CACHE_DISK_DEMOTIONS = "demotions"            # pressure-driven mem->disk
CACHE_DISK_EVICTIONS = "evictions"            # bound/validation drops
CACHE_DISK_BYTES = "bytes"                    # gauge: on-disk bytes now
CACHE_DISK_STAGED_UPLOADS = "staged_uploads"  # uploads acked from stage
CACHE_DISK_STAGE_MS = "stage_ms"              # one encode->staged write
# latency histograms (ms) fed by obs/trace.py spans that name them
SCAN_SPLIT_MS = "split_ms"                  # scan: whole read_split
SCAN_MERGE_MS = "merge_ms"                  # scan: one split's merge
WRITE_SORT_MS = "sort_ms"                   # write: buffer sort/dedup
WRITE_FLUSH_TASK_MS = "flush_task_ms"       # write: whole flush task
IO_READ_MS = "read_ms"                      # io: store -> bytes
IO_DECODE_MS = "decode_ms"                  # io: bytes -> Arrow
IO_ENCODE_MS = "encode_ms"                  # io: Arrow -> bytes
IO_UPLOAD_MS = "upload_ms"                  # io: bytes -> store
COMPACTION_WINDOW_MS = "window_ms"          # one mesh window merge
COMPACTION_FALLBACK_MS = "fallback_ms"      # one single-chip rescue
COMMIT_CAS_MS = "cas_ms"                    # commit: one CAS publish
COMMIT_MANIFEST_ENCODE_MS = "manifest_encode_ms"

# stream group (producer service/stream_daemon.py).  freshness_ms is end
# to end: event pulled from the CDC source -> its checkpoint's rows
# visible to a changelog scan.
STREAM_EVENTS_INGESTED = "events_ingested"    # CDC events written
STREAM_CHECKPOINTS = "checkpoints"            # offset commits that landed
STREAM_CHECKPOINT_MS = "checkpoint_ms"        # one checkpoint commit
STREAM_LOOP_RESTARTS = "loop_restarts"        # supervised loop restarts
STREAM_FRESHNESS_MS = "freshness_ms"          # event -> changelog-visible
STREAM_CHANGELOG_ROWS = "changelog_rows_served"
STREAM_COMPACTIONS = "compactions"            # triggered compaction runs
STREAM_COMPACTIONS_PAUSED = "compactions_paused"  # skipped: ingest pressure
STREAM_SOURCE_BACKLOG = "source_backlog"      # gauge: unpulled events

# service group (service/admission.py, async_server.py, delta.py,
# query_service.py); per-tenant in-flight bytes are one gauge per
# tenant: group("service", tenant) -> prometheus label table="<tenant>"
SERVICE_REQUESTS = "requests"                 # admitted requests
SERVICE_REJECTED = "rejected"                 # 429s: queue full/timeout
SERVICE_QUEUE_DEPTH = "queue_depth"           # gauge: waiters right now
SERVICE_INFLIGHT_BYTES = "inflight_bytes"     # gauge: admitted bytes now
SERVICE_TENANT_BYTES = "tenant_inflight_bytes"    # gauge, per tenant
SERVICE_ADMISSION_WAIT_MS = "admission_wait_ms"   # queued -> admitted
SERVICE_LOOKUP_MS = "lookup_ms"               # whole /lookup request
SERVICE_SCAN_MS = "scan_ms"                   # whole /scan request
SERVICE_CHANGELOG_MS = "changelog_ms"         # whole /changelog poll
SERVICE_LOOKUP_KEYS = "lookup_keys"           # point-get keys served
SERVICE_LOOKUP_CPU_MS = "lookup_cpu_per_key_ms"   # handler CPU per key
SERVICE_LOOP_LAG_MS = "loop_lag_ms"           # response ready -> flushed
SERVICE_CONNECTIONS = "connections"           # gauge: open sockets now
SERVICE_DELTA_ROWS = "delta_rows"             # gauge: delta-tier rows
SERVICE_DELTA_BYTES = "delta_bytes"           # gauge: delta-tier bytes
SERVICE_DELTA_OVERFLOWS = "delta_overflow"    # writes past max-bytes
SERVICE_ROUTER_FORWARDED = "router_forwarded"     # proxied requests
SERVICE_ROUTER_UPSTREAM_ERRORS = "router_upstream_errors"
SERVICE_ROUTER_RING_CHANGES = "router_ring_changes"   # join/leave/
# suspend/re-admit events (service/router.py)
SERVICE_SCAN_CACHE_HITS = "scan_cache_hits"       # snapshot-keyed
SERVICE_SCAN_CACHE_MISSES = "scan_cache_misses"   # /scan result cache

# lookup group (lookup/sst.py, lookup/local_query.py): native_probes
# counts probe batches the C path resolved, native_fallbacks those
# that wanted it and took the numpy walk
LOOKUP_BLOCK_CACHE_HITS = "block_cache_hits"
LOOKUP_BLOCK_CACHE_MISSES = "block_cache_misses"
LOOKUP_READER_BUILDS = "reader_builds"        # SSTs built (file reads)
LOOKUP_READER_REUSES = "reader_reuses"        # SSTs served warm
LOOKUP_FILES_PRUNED = "files_pruned"          # skipped by stats, no IO
LOOKUP_SNAPSHOT_REFRESHES = "snapshot_refreshes"  # plan reloads
LOOKUP_DELTA_HITS = "delta_hits"              # keys answered by delta
LOOKUP_NATIVE_PROBES = "native_probes"
LOOKUP_NATIVE_FALLBACKS = "native_fallbacks"

# resilience group (fs/resilience.py, utils/deadline.py,
# service/brownout.py, service/admission.py).  The breaker state gauge
# is one series per backend: group("resilience", backend name);
# 0 closed, 1 half-open, 2 open
RESILIENCE_HEDGES_ISSUED = "hedges_issued"      # hedge requests sent
RESILIENCE_HEDGES_WON = "hedges_won"            # hedge beat the primary
RESILIENCE_HEDGES_ABANDONED = "hedges_abandoned"  # loser left running
RESILIENCE_BREAKER_STATE = "breaker_state"      # gauge, per backend
RESILIENCE_BREAKER_FAST_FAILS = "breaker_fast_fails"  # open-circuit rejects
RESILIENCE_HEDGE_WAIT_MS = "hedge_wait_ms"      # delay before the hedge
RESILIENCE_DEADLINE_EXCEEDED = "deadline_exceeded"    # tripped scopes
RESILIENCE_BROWNOUT_SHEDS = "brownout_sheds"    # requests shed
RESILIENCE_BROWNOUT_LEVEL = "brownout_level"    # gauge: current rung

# slo group (obs/slo.py): burn = bad-event rate / error budget
SLO_AVAILABILITY_BURN_FAST = "availability_burn_fast"
SLO_AVAILABILITY_BURN_SLOW = "availability_burn_slow"
SLO_LATENCY_BURN_FAST = "latency_burn_fast"
SLO_LATENCY_BURN_SLOW = "latency_burn_slow"
SLO_ALERT = "alert"
SLO_GOOD_EVENTS = "good_events"
SLO_BAD_EVENTS = "bad_events"

# fixed upper bounds (ms) of a histogram's cumulative buckets
HISTOGRAM_BUCKET_BOUNDS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0)


class Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self._v += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """A set value, or the value of `fn` read at each snapshot."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._fn = fn
        self._v = 0.0

    def set(self, v: float):
        self._v = v

    @property
    def value(self) -> float:
        return self._fn() if self._fn is not None else self._v


class Histogram:
    """Sliding-window histogram (reference DescriptiveStatisticsHistogram
    with window size 100) plus cumulative count, sum and per-bound
    bucket counts, all under one lock."""

    def __init__(self, window: int = 100):
        self.window = window
        self._values: deque = deque(maxlen=max(1, int(window)))
        self._total_count = 0
        self._total_sum = 0.0
        self._bucket_slots = [0] * len(HISTOGRAM_BUCKET_BOUNDS_MS)
        self._lock = threading.Lock()

    def update(self, v: float):
        i = bisect.bisect_left(HISTOGRAM_BUCKET_BOUNDS_MS, v)
        with self._lock:
            self._values.append(v)
            self._total_count += 1
            self._total_sum += v
            if i < len(self._bucket_slots):
                self._bucket_slots[i] += 1

    def bucket_counts(self) -> List[tuple]:
        """Cumulative ``(le_bound_ms, count)`` pairs ending with
        ``(inf, total_count)``."""
        with self._lock:
            slots = list(self._bucket_slots)
            total = self._total_count
        out, run = [], 0
        for bound, n in zip(HISTOGRAM_BUCKET_BOUNDS_MS, slots):
            run += n
            out.append((bound, run))
        out.append((float("inf"), total))
        return out

    @property
    def total_count(self) -> int:
        with self._lock:
            return self._total_count

    @property
    def total_sum(self) -> float:
        with self._lock:
            return self._total_sum

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._values)

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._values:
                return 0.0
            vals = sorted(self._values)
            return vals[min(len(vals) - 1, int(p / 100 * len(vals)))]

    def window_values(self) -> List[float]:
        """The trailing sample window."""
        with self._lock:
            return list(self._values)

    @property
    def mean(self) -> float:
        with self._lock:
            if not self._values:
                return 0.0
            return sum(self._values) / len(self._values)

    @property
    def max(self) -> float:
        with self._lock:
            return max(self._values) if self._values else 0.0


class MetricGroup:
    def __init__(self, name: str):
        self.name = name
        self.metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: type, factory: Callable):
        """Allocated on first use; a name reused across kinds raises."""
        with self._lock:
            m = self.metrics.get(name)
            if m is None:
                m = self.metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} in group {self.name!r} is a "
                    f"{type(m).__name__}, not a {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(fn))

    def histogram(self, name: str, window: int = 100) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(window))


class MetricRegistry:
    """reference metrics/MetricRegistry.java: groups keyed by
    (group_type, table)."""

    def __init__(self):
        self._groups: Dict[str, MetricGroup] = {}
        self._lock = threading.Lock()

    def group(self, group_type: str, table: str = "") -> MetricGroup:
        key = f"{group_type}:{table}" if table else group_type
        with self._lock:
            return self._groups.setdefault(key, MetricGroup(key))

    def scan_metrics(self, table: str = "") -> MetricGroup:
        return self.group("scan", table)

    def compaction_metrics(self, table: str = "") -> MetricGroup:
        return self.group("compaction", table)

    def commit_metrics(self, table: str = "") -> MetricGroup:
        return self.group("commit", table)

    def write_metrics(self, table: str = "") -> MetricGroup:
        """Pipelined write plane (parallel/write_pipeline.py)."""
        return self.group("write", table)

    def cache_disk_metrics(self, table: str = "") -> MetricGroup:
        """The host-SSD read tier and the write path's staged
        uploads."""
        return self.group("cache_disk", table)

    def maintenance_metrics(self, table: str = "") -> MetricGroup:
        """Expire / orphan-clean / fsck plane."""
        return self.group("maintenance", table)

    def stream_metrics(self, table: str = "") -> MetricGroup:
        """Streaming-daemon plane (service/stream_daemon.py)."""
        return self.group("stream", table)

    def plan_metrics(self, table: str = "") -> MetricGroup:
        return self.group("plan", table)

    def fleet_metrics(self, table: str = "") -> MetricGroup:
        """Self-healing fleet plane: coordinated rejoin
        (parallel/maintenance_plane.py) and incremental fsck sweeps
        (maintenance/fsck.py)."""
        return self.group("fleet", table)

    def multihost_metrics(self, table: str = "") -> MetricGroup:
        """Multi-host planes: barriers (parallel/multihost.py), the
        sharded write plane (parallel/distributed.py) and the
        maintenance plane's leases and takeovers."""
        return self.group("multihost", table)

    def service_metrics(self, table: str = "") -> MetricGroup:
        """Query-serving plane; `table` doubles as the tenant id of the
        per-tenant gauges."""
        return self.group("service", table)

    def lookup_metrics(self, table: str = "") -> MetricGroup:
        return self.group("lookup", table)

    def resilience_metrics(self, table: str = "") -> MetricGroup:
        return self.group("resilience", table)

    def slo_metrics(self, table: str = "") -> MetricGroup:
        return self.group("slo", table)

    def snapshot_rows(self) -> List[Dict[str, object]]:
        """Flat typed rows, the one serialization behind `snapshot()`
        and the Prometheus text: {"group", "table", "metric", "kind",
        "value"} plus, for histograms, count, mean, p95, max and the
        cumulative totals and buckets.  `value` is the counter's count,
        the gauge's value or the histogram's mean."""
        with self._lock:
            groups = list(self._groups.items())
        rows: List[Dict[str, object]] = []
        for gkey, group in groups:
            gtype, _, gtable = gkey.partition(":")
            with group._lock:
                metrics = list(group.metrics.items())
            for mname, m in metrics:
                base = {"group": gtype, "table": gtable, "metric": mname}
                if isinstance(m, Counter):
                    rows.append({**base, "kind": "counter",
                                 "value": m.count})
                elif isinstance(m, Gauge):
                    rows.append({**base, "kind": "gauge",
                                 "value": m.value})
                else:
                    mean = m.mean
                    rows.append({**base, "kind": "histogram",
                                 "value": mean, "count": m.count,
                                 "mean": mean,
                                 "p95": m.percentile(95), "max": m.max,
                                 "total_count": m.total_count,
                                 "total_sum": m.total_sum,
                                 "buckets": m.bucket_counts()})
        return rows

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{group: {metric: value}}; histograms render as {count, mean,
        p95, max}."""
        out: Dict[str, Dict[str, object]] = {}
        for r in self.snapshot_rows():
            gkey = f"{r['group']}:{r['table']}" if r["table"] \
                else r["group"]
            d = out.setdefault(gkey, {})
            if r["kind"] == "histogram":
                d[r["metric"]] = {"count": r["count"], "mean": r["mean"],
                                  "p95": r["p95"], "max": r["max"]}
            else:
                d[r["metric"]] = r["value"]
        return out


_GLOBAL = MetricRegistry()


def global_registry() -> MetricRegistry:
    return _GLOBAL


class CompactTimer:
    """Sliding-window busy time: how many milliseconds of the last
    `window_ms` were spent compacting (reference
    compact/CompactTimer.java).  Overlapping tasks share one interval
    (a depth count under a lock)."""

    def __init__(self, window_ms: int = 60_000, clock=None):
        self.window_ms = window_ms
        self._clock = clock or (lambda: int(time.time() * 1000))
        self._intervals: list = []      # [start, end or None]
        self._depth = 0
        self._lock = threading.Lock()

    def start(self, now: Optional[int] = None):
        now = self._clock() if now is None else now
        with self._lock:
            self._trim(now)
            if self._depth == 0:
                self._intervals.append([now, None])
            self._depth += 1

    def stop(self, now: Optional[int] = None):
        now = self._clock() if now is None else now
        with self._lock:
            if self._depth > 0:
                self._depth -= 1
                if self._depth == 0:
                    self._intervals[-1][1] = now

    def _trim(self, now: int):
        horizon = now - self.window_ms
        self._intervals = [iv for iv in self._intervals
                           if iv[1] is None or iv[1] > horizon]

    def busy_millis(self, now: Optional[int] = None) -> int:
        """Compaction-busy milliseconds within the trailing window."""
        now = self._clock() if now is None else now
        horizon = now - self.window_ms
        with self._lock:
            self._trim(now)
            total = 0
            for start, end in self._intervals:
                e = now if end is None else min(end, now)
                s = max(start, horizon)
                if e > s:
                    total += e - s
            return total

    def busy_ratio(self, now: Optional[int] = None) -> float:
        return self.busy_millis(now) / self.window_ms
