"""Metric registry: counters, gauges and latency histograms by group.

Counterpart of paimon_tpu/metrics.py, reduced to what the ported
planes record: the compaction group's fault counters and window /
fallback histograms, the scan group's device-decode fallbacks and
byte-cache counters, and the serving plane's service, lookup,
resilience and slo groups.  `snapshot_rows` is the one serialization
behind `snapshot()` and the Prometheus text of obs/export.py.  The
reference's other groups (commit, write, stream, multihost, plan,
fleet, cache_disk) and CompactTimer are not ported yet.

reference: paimon-core/.../metrics/ (MetricRegistry, Counter, Gauge,
Histogram) with groups ScanMetrics / CompactionMetrics.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Callable, Dict, List

__all__ = ["Counter", "Gauge", "Histogram", "MetricGroup",
           "MetricRegistry", "global_registry",
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
           "SLO_ALERT", "SLO_GOOD_EVENTS", "SLO_BAD_EVENTS"]

# fault-tolerance counters of the compaction group (producer:
# parallel/mesh_engine.py):
#   bucket_retries   — transient per-bucket failures that were retried
#   bucket_fallbacks — buckets degraded to the single-chip path
#   bucket_failures  — buckets that exhausted the whole ladder (raised)
COMPACTION_BUCKET_RETRIES = "bucket_retries"
COMPACTION_BUCKET_FALLBACKS = "bucket_fallbacks"
COMPACTION_BUCKET_FAILURES = "bucket_failures"
# scan group: parquet files the device decode plane handed back to the
# pyarrow host path
SCAN_DEVICE_DECODE_FALLBACKS = "device_decode_fallbacks"
# scan group: the byte and footer caches of fs/caching.py
SCAN_FILE_CACHE_HITS = "file_cache_hits"
SCAN_FILE_CACHE_MISSES = "file_cache_misses"
SCAN_FOOTER_CACHE_HITS = "footer_cache_hits"
SCAN_FOOTER_CACHE_MISSES = "footer_cache_misses"
SCAN_RANGE_CACHE_HITS = "range_cache_hits"
SCAN_RANGE_CACHE_MISSES = "range_cache_misses"
SCAN_RANGE_CACHE_HIT_BYTES = "range_cache_hit_bytes"
# latency histograms (ms) fed by obs/trace.py spans that name them
COMPACTION_WINDOW_MS = "window_ms"          # one mesh window merge
COMPACTION_FALLBACK_MS = "fallback_ms"      # one single-chip rescue

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

# resilience group (utils/deadline.py, service/brownout.py,
# service/admission.py)
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
    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = v


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

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

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
