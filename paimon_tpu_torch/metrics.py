"""Metric registry: counters and latency histograms by group.

Counterpart of paimon_tpu/metrics.py, reduced to what the mesh
compaction plane records: the compaction group's fault counters and
window / fallback latency histograms, and the scan group's device
decode fallbacks.  The rest of the reference's registry (gauges,
snapshots, Prometheus rows, the other groups' names) is not ported yet
(ROADMAP.md A.7).

reference: paimon-core/.../metrics/ (MetricRegistry, Counter,
Histogram) with groups ScanMetrics / CompactionMetrics.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Callable, Dict, List

__all__ = ["Counter", "Histogram", "MetricGroup", "MetricRegistry",
           "global_registry", "COMPACTION_BUCKET_RETRIES",
           "COMPACTION_BUCKET_FALLBACKS", "COMPACTION_BUCKET_FAILURES",
           "SCAN_DEVICE_DECODE_FALLBACKS", "COMPACTION_WINDOW_MS",
           "COMPACTION_FALLBACK_MS"]

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
# latency histograms (ms) fed by obs/trace.py spans that name them
COMPACTION_WINDOW_MS = "window_ms"          # one mesh window merge
COMPACTION_FALLBACK_MS = "fallback_ms"      # one single-chip rescue

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


_GLOBAL = MetricRegistry()


def global_registry() -> MetricRegistry:
    return _GLOBAL
