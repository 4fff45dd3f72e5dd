"""Config system.

Counterpart of paimon_tpu/options.py, reduced to the options this
package reads; keys are spelled exactly as the reference spells them.
Unknown keys round-trip through ``Options`` untouched, so a table's
stored options mean the same thing in both packages.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Optional

__all__ = ["ConfigOption", "Options", "CoreOptions", "MergeEngine",
           "ChangelogProducer", "StartupMode", "parse_memory_size"]


_SIZE_RE = re.compile(r"^\s*(\d+)\s*([kKmMgGtT]?)[bB]?\s*$")
_UNITS = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_memory_size(v) -> int:
    """'128 mb' / '1g' / 1024 -> bytes (reference options/MemorySize.java)."""
    if isinstance(v, int):
        return v
    m = _SIZE_RE.match(str(v))
    if not m:
        raise ValueError(f"Cannot parse memory size: {v!r}")
    return int(m.group(1)) * _UNITS[m.group(2).lower()]


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def _validate_enum(v, allowed):
    s = str(v).upper()
    if s not in allowed:
        raise ValueError(f"{v!r} not in {allowed}")
    return s


def _enum(*allowed):
    """Named enum validator (the name renders in generated docs)."""
    def validate(v):
        return _validate_enum(v, allowed)
    validate.__name__ = "enum[" + "|".join(allowed) + "]"
    return validate


def _parse_duration_ms(v) -> int:
    """'1 s' / '5 min' / '100ms' -> milliseconds."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    m = re.match(r"^(\d+)\s*([a-z]*)$", s)
    if not m:
        raise ValueError(f"Cannot parse duration: {v!r}")
    n, unit = int(m.group(1)), m.group(2)
    mult = {"": 1, "ms": 1, "s": 1000, "sec": 1000, "min": 60000,
            "m": 60000, "h": 3600000, "d": 86400000}[unit]
    return n * mult


class ConfigOption:
    """A typed option with key, default, and description."""

    def __init__(self, key: str, typ: Callable[[Any], Any], default: Any,
                 description: str = ""):
        self.key = key
        self.typ = typ
        self.default = default
        self.description = description

    def parse(self, raw: Any) -> Any:
        if raw is None:
            return self.default
        return self.typ(raw)

    def __repr__(self):
        return f"ConfigOption({self.key!r}, default={self.default!r})"


class Options:
    """String->string map with typed access (reference options/Options.java)."""

    def __init__(self, conf: Optional[Dict[str, Any]] = None):
        self._map: Dict[str, str] = {}
        if conf:
            for k, v in conf.items():
                self.set(k, v)

    def set(self, key, value) -> "Options":
        if isinstance(key, ConfigOption):
            key = key.key
        self._map[key] = str(value) if not isinstance(value, str) else value
        return self

    def get(self, option):
        if isinstance(option, ConfigOption):
            return option.parse(self._map.get(option.key))
        return self._map.get(option)

    def get_or(self, key: str, default):
        return self._map.get(key, default)

    def contains(self, key) -> bool:
        if isinstance(key, ConfigOption):
            key = key.key
        return key in self._map

    def remove(self, key: str):
        self._map.pop(key, None)

    def keys(self) -> Iterable[str]:
        return self._map.keys()

    def to_map(self) -> Dict[str, str]:
        return dict(self._map)

    def copy(self) -> "Options":
        return Options(dict(self._map))

    def __eq__(self, other):
        return isinstance(other, Options) and self._map == other._map

    def __repr__(self):
        return f"Options({self._map})"


# -- enums (reference CoreOptions.java:4590,4619,4759) -----------------------

class MergeEngine:
    DEDUPLICATE = "deduplicate"
    PARTIAL_UPDATE = "partial-update"
    AGGREGATE = "aggregation"
    FIRST_ROW = "first-row"


class ChangelogProducer:
    NONE = "none"
    INPUT = "input"
    FULL_COMPACTION = "full-compaction"
    LOOKUP = "lookup"


class StartupMode:
    DEFAULT = "default"
    LATEST_FULL = "latest-full"
    FULL = "full"
    LATEST = "latest"
    COMPACTED_FULL = "compacted-full"
    FROM_TIMESTAMP = "from-timestamp"
    FROM_SNAPSHOT = "from-snapshot"
    FROM_SNAPSHOT_FULL = "from-snapshot-full"
    INCREMENTAL = "incremental"


class CoreOptions:
    """Typed view over table options (reference CoreOptions.java)."""

    BUCKET = ConfigOption("bucket", int, -1, "Bucket count; -1 = unaware/dynamic")
    FILE_FORMAT = ConfigOption("file.format", str, "parquet", "Data file format")
    FILE_FORMAT_PER_LEVEL = ConfigOption(
        "file.format.per.level", str, None,
        "Per-LSM-level format overrides, e.g. '0:avro,5:parquet' — "
        "fast row codec for hot L0, columnar for settled levels "
        "(reference CoreOptions file.format.per.level)")
    FILE_COMPRESSION_ZSTD_LEVEL = ConfigOption(
        "file.compression.zstd-level", int, None,
        "zstd level for data files (reference CoreOptions"
        ".FILE_COMPRESSION_ZSTD_LEVEL); None = codec default")
    FILE_COMPRESSION = ConfigOption("file.compression", str, "zstd",
                                    "Data file compression")
    MANIFEST_MERGE_MIN_COUNT = ConfigOption("manifest.merge-min-count", int, 30,
                                            "Min manifests to trigger full rewrite")
    MERGE_ENGINE = ConfigOption("merge-engine", str, MergeEngine.DEDUPLICATE,
                                "deduplicate | partial-update | aggregation | first-row")
    IGNORE_DELETE = ConfigOption("ignore-delete", _parse_bool, False, "")
    CHANGELOG_PRODUCER = ConfigOption("changelog-producer", str,
                                      ChangelogProducer.NONE, "")
    SEQUENCE_FIELD = ConfigOption("sequence.field", str, None,
                                  "User-defined sequence column(s)")
    PARTITION_DEFAULT_NAME = ConfigOption("partition.default-name", str,
                                          "__DEFAULT_PARTITION__", "")
    PARTIAL_UPDATE_REMOVE_RECORD_ON_DELETE = ConfigOption(
        "partial-update.remove-record-on-delete", _parse_bool, False,
        "-D on a partial-update table drops the whole row instead of "
        "being ignored")
    AGGREGATION_REMOVE_RECORD_ON_DELETE = ConfigOption(
        "aggregation.remove-record-on-delete", _parse_bool, False,
        "-D on an aggregation table drops the accumulated row")
    TARGET_FILE_SIZE = ConfigOption("target-file-size", parse_memory_size,
                                    128 << 20, "Target data file size")
    WRITE_BUFFER_SPILLABLE = ConfigOption(
        "write-buffer-spillable", _parse_bool, False,
        "Primary-key writers only: spill full write buffers to local "
        "sorted runs (zstd Arrow IPC) and merge them into L0 at "
        "prepare-commit — fewer, larger L0 files than flushing one "
        "file per buffer-full")
    WRITE_BUFFER_SIZE = ConfigOption("write-buffer-size", parse_memory_size,
                                     256 << 20, "Sort buffer memory")
    WRITE_ONLY = ConfigOption("write-only", _parse_bool, False,
                              "Skip compaction on write")
    NUM_SORTED_RUNS_COMPACTION_TRIGGER = ConfigOption(
        "num-sorted-run.compaction-trigger", int, 5,
        "Sorted runs triggering compaction (reference CoreOptions.java:876)")
    NUM_SORTED_RUNS_STOP_TRIGGER = ConfigOption(
        "num-sorted-run.stop-trigger", int, None, "Write-stall threshold")
    NUM_LEVELS = ConfigOption("num-levels", int, None, "LSM levels")
    COMPACTION_MAX_SIZE_AMPLIFICATION_PERCENT = ConfigOption(
        "compaction.max-size-amplification-percent", int, 200, "")
    COMPACTION_SIZE_RATIO = ConfigOption("compaction.size-ratio", int, 1, "")
    SCAN_MODE = ConfigOption("scan.mode", str, StartupMode.DEFAULT, "")
    SCAN_SNAPSHOT_ID = ConfigOption("scan.snapshot-id", int, None, "")
    SCAN_TAG_NAME = ConfigOption("scan.tag-name", str, None, "")
    SCAN_TIMESTAMP_MILLIS = ConfigOption("scan.timestamp-millis", int, None, "")
    SCAN_FALLBACK_BRANCH = ConfigOption("scan.fallback-branch", str, None, "")
    INCREMENTAL_BETWEEN = ConfigOption("incremental-between", str, None, "")
    CONSUMER_ID = ConfigOption("consumer-id", str, None, "")
    DELETION_VECTORS_ENABLED = ConfigOption("deletion-vectors.enabled",
                                            _parse_bool, False, "")
    DELETION_VECTORS_MERGE_ON_READ = ConfigOption(
        "deletion-vectors.merge-on-read", _parse_bool, True,
        "Apply deletion vectors during reads (false: raw rows visible, "
        "for debugging/audit scans)")
    # -- append tables (reference CoreOptions.java) --------------------------
    COMPACTION_MIN_FILE_NUM = ConfigOption("compaction.min.file-num", int,
                                           5, "")
    COMPACTION_DELETE_RATIO_THRESHOLD = ConfigOption(
        "compaction.delete-ratio-threshold", float, 0.2,
        "Append tables: force-compact a data file once deletion "
        "vectors mark more than this share of its rows deleted")
    COMPACTION_SMALL_FILE_RATIO = ConfigOption(
        "compaction.small-file-ratio", float, 0.7,
        "Files below target-file-size * this ratio are picked for "
        "compaction rewriting (avoids re-compacting outputs that "
        "compressed slightly under target)")
    SOURCE_SPLIT_TARGET_SIZE = ConfigOption(
        "source.split.target-size", parse_memory_size, 128 << 20,
        "Append-table buckets bin into splits of about this size")
    SOURCE_SPLIT_OPEN_FILE_COST = ConfigOption(
        "source.split.open-file-cost", parse_memory_size, 4 << 20, "")
    # -- dynamic bucket (reference CoreOptions.java:1650-1700) ---------------
    DYNAMIC_BUCKET_TARGET_ROW_NUM = ConfigOption(
        "dynamic-bucket.target-row-num", int, 2_000_000, "")
    # the next three size a Flink job's parallel assigners; one process
    # runs one assigner, so they change no bucket (as in the reference)
    DYNAMIC_BUCKET_INITIAL_BUCKETS = ConfigOption(
        "dynamic-bucket.initial-buckets", int, None, "")
    DYNAMIC_BUCKET_ASSIGNER_PARALLELISM = ConfigOption(
        "dynamic-bucket.assigner-parallelism", int, None, "")
    DYNAMIC_BUCKET_MAX_BUCKETS = ConfigOption(
        "dynamic-bucket.max-buckets", int, -1,
        "Upper bound on auto-created buckets (-1 = unbounded)")

    # -- cross-partition upsert (reference CoreOptions.java:1930) ------------
    CROSS_PARTITION_UPSERT_INDEX_TTL = ConfigOption(
        "cross-partition-upsert.index-ttl", _parse_duration_ms, None,
        "Drop global-index entries idle past this (bounds index size; "
        "late rows for dropped keys create new partitions)")
    # the bootstrap is one projected scan through the split pool here, so
    # this sizes nothing and changes no row (as in the reference)
    CROSS_PARTITION_UPSERT_BOOTSTRAP_PARALLELISM = ConfigOption(
        "cross-partition-upsert.bootstrap-parallelism", int, 10,
        "Parallel readers bootstrapping the cross-partition index")

    # -- postpone bucket mode (reference postpone.* family) ------------------
    POSTPONE_DEFAULT_BUCKET_NUM = ConfigOption(
        "postpone.default-bucket-num", int, 4,
        "Bucket count chosen when rescale_postpone runs without an "
        "explicit target")
    POSTPONE_TARGET_ROW_NUM_PER_BUCKET = ConfigOption(
        "postpone.target-row-num-per-bucket", int, 5_000_000,
        "Rows per bucket targeted when sizing the rescale of postponed "
        "data")

    # -- schema evolution toggles --------------------------------------------
    ALTER_NULL_TO_NOT_NULL_DISABLED = ConfigOption(
        "alter-column-null-to-not-null.disabled", _parse_bool, True,
        "Refuse ALTER that tightens a nullable column to NOT NULL "
        "(existing nulls would break readers)")
    DISABLE_EXPLICIT_TYPE_CASTING = ConfigOption(
        "disable-explicit-type-casting", _parse_bool, False,
        "Refuse ALTER column-type changes that require a value cast "
        "(only metadata-compatible widenings allowed)")
    ADD_COLUMN_BEFORE_PARTITION = ConfigOption(
        "add-column-before-partition", _parse_bool, False,
        "New columns are inserted before the partition columns instead "
        "of appended at the end")
    MERGE_STREAM_THRESHOLD_ROWS = ConfigOption(
        "tpu.merge.stream-threshold-rows", int, 8 << 20,
        "Above this many input rows a compaction merges in streamed key "
        "windows instead of one whole-bucket kernel: the streamed "
        "pipeline overlaps decode/encode with the merge and bounds "
        "memory (ours)")
    MERGE_CHUNK_ROWS = ConfigOption(
        "tpu.merge.chunk-rows", int, 4 << 20,
        "Decoded chunk rows per run for the streamed merge (ours); "
        "larger windows amortize per-window sync/flush overhead at "
        "~runs x rows x row-bytes peak memory")
    MERGE_WINDOW_ROWS = ConfigOption(
        "tpu.merge.window-rows", int, 1 << 18,
        "Per-run row cap of one streamed merge key window (ours): the "
        "window bound is lowered to the smallest buffered key at this "
        "row index, so a window carries ~runs x this many rows and "
        "adjacent windows overlap on the merge workers instead of one "
        "window swallowing the whole bucket; a key group wider than "
        "the cap falls back to the natural bound (keys never straddle "
        "windows)")
    MESH_COMPACT = ConfigOption(
        "tpu.mesh.compact", _parse_bool, False,
        "Route full compactions of primary-key tables through the "
        "streaming mesh engine (parallel/mesh_engine.py): all buckets "
        "compact in one mesh program, streamed in bounded key windows "
        "with skew-aware bucket->device packing (ours)")
    MESH_WINDOW_ROWS = ConfigOption(
        "tpu.mesh.window-rows", int, 1 << 20,
        "Decoded chunk rows per sorted run for the mesh engine's "
        "bounded key windows (ours)")
    COMPACTION_RETRY_MAX_ATTEMPTS = ConfigOption(
        "compaction.retry.max-attempts", int, 3,
        "Per-bucket attempts a mesh compaction makes on a transient "
        "failure (503 storms, IO faults, lane or device loss) before "
        "degrading that bucket to the single-chip path")
    COMPACTION_RETRY_BACKOFF = ConfigOption(
        "compaction.retry.backoff", _parse_duration_ms, 10,
        "Base wait between per-bucket compaction retries; actual "
        "waits use capped decorrelated jitter (utils/backoff.py)")
    COMPACTION_MESH_FALLBACK = ConfigOption(
        "compaction.mesh.fallback", _parse_bool, True,
        "After retries are exhausted, degrade the failing bucket to "
        "the single-chip compact/manager.py path instead of failing "
        "the whole mesh job; false = raise once retries run out")
    METRICS_ENABLED = ConfigOption(
        "metrics.enabled", _parse_bool, True,
        "Record per-stage latency histograms into the process metric "
        "registry (metrics.py); process-global, synced from table "
        "options at pipeline entry: an explicitly set value wins, an "
        "absent key leaves the current process state")
    TRACE_ENABLED = ConfigOption(
        "trace.enabled", _parse_bool, False,
        "Collect structured spans (obs/trace.py) into the bounded "
        "in-process ring; process-global like metrics.enabled")
    TRACE_BUFFER_SPANS = ConfigOption(
        "trace.buffer.spans", int, 8192,
        "Capacity of the bounded span ring; the oldest spans evict "
        "first")
    TRACE_EXPORT_PATH = ConfigOption(
        "trace.export.path", str, None,
        "When set (with trace.enabled), the span ring is written to "
        "this file as Chrome trace-event JSON when a mesh compaction "
        "finishes")
    TRACE_EXPORT_DIR = ConfigOption(
        "trace.export.dir", str, None,
        "Spool directory: each process appends its spans to its own "
        "<dir>/<process-tag>.jsonl at the same completion points")
    SCAN_IGNORE_CORRUPT_FILES = ConfigOption(
        "scan.ignore-corrupt-files", _parse_bool, False,
        "Skip unreadable data files during scans (warn) instead of "
        "failing the query")
    WRITE_STAGE_DIR = ConfigOption(
        "write.stage.dir", str, None,
        "When set, flush workers encode data and changelog files to a "
        "staged local file here and hand the store upload to an async "
        "upload pool; upload retries re-read the staged bytes, and "
        "prepare_commit() still waits for every upload's ack.  None = "
        "the inline upload path")
    # tail tolerance (utils/deadline.py, fs/resilience.py)
    REQUEST_TIMEOUT = ConfigOption(
        "request.timeout", _parse_duration_ms, None,
        "End-to-end deadline for table entry points (reads, commits, "
        "CLI ops): a Deadline is installed at entry and honored by "
        "every blocking wait downstream — retry-ladder sleeps, "
        "scan/write byte-budget blocks, admission queues, store IO — "
        "raising the typed DeadlineExceededError once spent (never "
        "retried, never orphan-committed).  None = no deadline")

    # -- query serving plane (service/, lookup/; reference options.py
    #    :325, :544-650, :865-985, :1165) ------------------------------------
    SERVICE_REQUEST_TIMEOUT = ConfigOption(
        "service.request.timeout", _parse_duration_ms, None,
        "Default end-to-end deadline for /lookup, /scan and /changelog "
        "requests (clients may override per request with "
        "'timeout_ms'); an exceeded deadline answers HTTP 504.  None = "
        "no server-side deadline")
    SERVICE_BROWNOUT_ENABLED = ConfigOption(
        "service.brownout.enabled", _parse_bool, True,
        "Graceful load shedding (service/brownout.py): under queue or "
        "failure pressure rung 1 marks the process degraded, rung 2 "
        "also sheds low-priority requests with HTTP 429")
    SERVICE_BROWNOUT_QUEUE_RATIO = ConfigOption(
        "service.brownout.queue-ratio", float, 0.5,
        "Admission-queue fill fraction past which the brownout ladder "
        "starts climbing")
    SERVICE_BROWNOUT_SHED_PRIORITY = ConfigOption(
        "service.brownout.shed-priority", int, 100,
        "At brownout rung 2, requests with priority below this are "
        "shed with HTTP 429")
    SERVICE_BROWNOUT_HOLD_MS = ConfigOption(
        "service.brownout.hold-ms", _parse_duration_ms, 1000,
        "Hysteresis: a brownout rung holds at least this long before "
        "the ladder may step back down")
    SERVICE_SLO_ENABLED = ConfigOption(
        "service.slo.enabled", _parse_bool, True,
        "Evaluate the availability and latency-p99 objectives as "
        "multi-window burn rates (obs/slo.py, GET /slo)")
    SERVICE_SLO_AVAILABILITY_TARGET = ConfigOption(
        "service.slo.availability-target", float, 0.999,
        "Fraction of requests that must succeed (429 and 5xx count "
        "against the budget)")
    SERVICE_SLO_LATENCY_P99_MS = ConfigOption(
        "service.slo.latency-p99-ms", float, 250.0,
        "99% of requests must finish within this many milliseconds")
    SERVICE_SLO_FAST_WINDOW_S = ConfigOption(
        "service.slo.fast-window-s", float, 300.0,
        "Fast burn-rate window (seconds)")
    SERVICE_SLO_SLOW_WINDOW_S = ConfigOption(
        "service.slo.slow-window-s", float, 3600.0,
        "Slow burn-rate window (seconds); at least the fast window")
    SERVICE_SLO_BURN_THRESHOLD = ConfigOption(
        "service.slo.burn-threshold", float, 2.0,
        "Burn rate both windows must reach to raise the alert")
    SERVICE_MAX_INFLIGHT_BYTES = ConfigOption(
        "service.max-inflight-bytes", parse_memory_size, 1 << 30,
        "Budget on the estimated bytes of requests admitted at once; "
        "further requests queue, and an idle service always admits one")
    SERVICE_TENANT_MAX_INFLIGHT_BYTES = ConfigOption(
        "service.tenant.max-inflight-bytes", parse_memory_size, None,
        "Per-tenant slice of the admission budget; None = the whole "
        "service.max-inflight-bytes")
    SERVICE_QUEUE_DEPTH = ConfigOption(
        "service.queue.depth", int, 256,
        "Bound on requests waiting for admission; a full queue answers "
        "HTTP 429 at once")
    SERVICE_QUEUE_TIMEOUT = ConfigOption(
        "service.queue.timeout", _parse_duration_ms, 10_000,
        "How long a queued request waits for budget before HTTP 429")
    SERVICE_LOOKUP_REFRESH_INTERVAL = ConfigOption(
        "service.lookup.refresh-interval", _parse_duration_ms, 100,
        "Snapshot-refresh TTL of the serving point-lookup engine: "
        "within it, lookups are answered from the cached plan (they "
        "may trail commits by up to this long)")
    SERVICE_CACHE_SHARED = ConfigOption(
        "service.cache.shared", _parse_bool, True,
        "Serve every request through the process-wide shared byte-"
        "cache tier (fs/caching.py shared_cache_state)")
    SERVICE_SCAN_ROW_BYTES = ConfigOption(
        "service.scan.row-bytes-estimate", int, 256,
        "Admission bytes charged per row of a /scan limit or a "
        "/changelog poll")
    SERVICE_LOOKUP_KEY_BYTES = ConfigOption(
        "service.lookup.key-bytes-estimate", int, 4096,
        "Admission bytes charged per /lookup key")
    SERVICE_WORKERS = ConfigOption(
        "service.workers", int, 16,
        "Handler threads behind the event-loop request engine "
        "(service/async_server.py)")
    SERVICE_MAX_CONNECTIONS = ConfigOption(
        "service.max-connections", int, 1024,
        "Bound on open client connections; accepts past it answer 503")
    SERVICE_PROBE_NATIVE = ConfigOption(
        "service.probe.native", _parse_bool, True,
        "Resolve SST probe batches with native/probe.c (bloom + binary "
        "search, GIL released); a call that cannot degrades to the "
        "numpy walk and counts lookup.native_fallbacks")
    SERVICE_DELTA_ENABLED = ConfigOption(
        "service.delta.enabled", _parse_bool, True,
        "Serve point lookups from the in-memory delta tier of a serving "
        "writer's unflushed rows (service/delta.py)")
    SERVICE_DELTA_MAX_BYTES = ConfigOption(
        "service.delta.max-bytes", parse_memory_size, 256 << 20,
        "Soft bound on the delta tier's bytes: crossing it counts "
        "delta_overflow (uncommitted rows are never dropped)")
    # the replica router (service/router.py), warm boot
    # (service/warmboot.py) and the host-SSD tier (fs/caching.py)
    SERVICE_REPLICAS = ConfigOption(
        "service.replicas", int, 1,
        "Read replicas started by ReplicaSet (service/router.py): N "
        "query servers over one table — sharing the process-wide "
        "byte-cache tier and the host-SSD tier — fronted by a router "
        "that consistent-hashes tenants across them; 1 = the classic "
        "single-server plane, no router")
    SERVICE_REPLICA_VNODES = ConfigOption(
        "service.replicas.virtual-nodes", int, 64,
        "Virtual nodes per replica on the router's consistent-hash "
        "ring: more vnodes = smoother tenant spread and smaller "
        "reassignment when the replica count changes")
    SERVICE_REPLICA_HEALTH_INTERVAL = ConfigOption(
        "service.replicas.health-interval", _parse_duration_ms, 1_000,
        "How often the router health-checks REMOTE replicas "
        "(processes on other machines registered via POST /register): "
        "an unreachable replica is taken out of the hash ring after "
        "two consecutive failures and re-admitted on the first "
        "successful check; in-process replicas are never checked — "
        "their liveness is the process's")
    SERVICE_WARMBOOT_ENABLED = ConfigOption(
        "service.warmboot.enabled", _parse_bool, False,
        "Boot serving replicas WARM from state persisted through the "
        "shared SSD tier: on stop (or an explicit POST /warmboot) a "
        "replica serializes its plan-cache state and hard-links its "
        "built SST files under service.warmboot.dir; the next replica "
        "over the same table restores them at query-engine "
        "construction and serves its first lookup with zero reader "
        "builds and no manifest walk.  Requires service.warmboot.dir "
        "or cache.disk.dir")
    SERVICE_WARMBOOT_DIR = ConfigOption(
        "service.warmboot.dir", str, None,
        "Directory the warm-boot state persists into — a shared SSD "
        "mount reachable by every machine's replicas (the same "
        "sharing contract as cache.disk.dir, which is also the "
        "default location: <cache.disk.dir>/warmboot)")
    CACHE_DISK_DIR = ConfigOption(
        "cache.disk.dir", str, None,
        "Directory of the host-SSD second cache tier under the "
        "in-memory byte caches (fs/caching.py DiskCacheTier): whole-"
        "file and block-range entries are promoted here on repeated "
        "hits or memory demotion and served on memory miss, each "
        "validated by a stored key/length/crc32 header so a stale or "
        "corrupted cache dir degrades to the object store instead of "
        "serving wrong bytes.  One tier per directory per process; "
        "None disables the disk tier")
    CACHE_DISK_MAX_BYTES = ConfigOption(
        "cache.disk.max-bytes", parse_memory_size, 1 << 30,
        "Hard bound on the on-disk bytes of the cache.disk.dir tier; "
        "space is reserved under the tier lock before any entry file "
        "is written, so concurrent readers can never overshoot it "
        "(oldest entries evict first)")
    CACHE_DISK_PROMOTE_HITS = ConfigOption(
        "cache.disk.promote-after-hits", int, 2,
        "In-memory hits of one entry after which it is also written "
        "to the disk tier (so a later memory demotion costs nothing); "
        "entries evicted from memory under pressure are demoted to "
        "disk regardless of hit count")
    READ_HEDGE_ENABLED = ConfigOption(
        "read.hedge.enabled", _parse_bool, False,
        "Hedge slow store reads (fs/resilience.py): GET/ranged-GET/"
        "HEAD/LIST track an online per-op-class latency quantile and "
        "a call still in flight past that delay issues ONE duplicate "
        "request — first success wins, the loser is abandoned.  Never "
        "applied to mutating ops; disabled automatically under "
        "brownout")
    READ_HEDGE_QUANTILE = ConfigOption(
        "read.hedge.quantile", float, 95.0,
        "Latency percentile of the op class's recent successes at "
        "which the hedge fires (95 = hedge the slowest ~5% of reads)")
    READ_HEDGE_MIN_DELAY = ConfigOption(
        "read.hedge.min-delay", _parse_duration_ms, 1,
        "Floor on the adaptive hedge delay, so a very fast store "
        "cannot drive the hedge trigger into micro-duplication")
    READ_HEDGE_MAX_RATIO = ConfigOption(
        "read.hedge.max-ratio", float, 0.05,
        "Hard cap on hedges as a fraction of hedgeable calls (0.05 = "
        "at most 5% extra load on the store, the classic tail-at-"
        "scale budget)")
    STORE_BREAKER_ENABLED = ConfigOption(
        "store.breaker.enabled", _parse_bool, False,
        "Per-backend circuit breaker (fs/resilience.py): a sick store "
        "trips closed->open and calls fail fast (<10ms, "
        "CircuitOpenError) instead of queueing retry ladders onto it; "
        "half-open probes re-close after store.breaker.open-ms")
    STORE_BREAKER_FAILURE_THRESHOLD = ConfigOption(
        "store.breaker.failure-threshold", int, 5,
        "Consecutive store failures that trip the breaker open")
    STORE_BREAKER_ERROR_RATE = ConfigOption(
        "store.breaker.error-rate", float, 0.5,
        "Windowed error-rate trip wire: the breaker also opens when "
        "at least this fraction of the last store.breaker.window "
        "outcomes failed (catches sustained partial sickness that "
        "never produces a long consecutive run)")
    STORE_BREAKER_WINDOW = ConfigOption(
        "store.breaker.window", int, 32,
        "Outcome window for the error-rate trip wire (must be full "
        "before the rate can trip)")
    STORE_BREAKER_OPEN_MS = ConfigOption(
        "store.breaker.open-ms", _parse_duration_ms, 5000,
        "How long an open breaker rejects before letting half-open "
        "probes through; a failed probe re-arms the full window")
    STORE_BREAKER_HALF_OPEN_PROBES = ConfigOption(
        "store.breaker.half-open-probes", int, 1,
        "Concurrent trial calls admitted in the half-open state; the "
        "first success re-closes the breaker")
    OBS_FLIGHT_ENABLED = ConfigOption(
        "obs.flight.enabled", _parse_bool, True,
        "Keep the flight recorder's bounded event ring (obs/flight.py)")
    OBS_FLIGHT_EVENTS = ConfigOption(
        "obs.flight.events", int, 512,
        "Capacity of the flight recorder's event ring")
    OBS_FLIGHT_DUMP_DIR = ConfigOption(
        "obs.flight.dump.dir", str, None,
        "Crash hooks and the stream daemon's signal handler dump the "
        "flight ring to flight-<host>-<pid>-<ms>.json under this "
        "directory")

    # -- streaming daemon (service/stream_daemon.py) ------------------------
    STREAM_CHECKPOINT_INTERVAL = ConfigOption(
        "stream.checkpoint.interval", _parse_duration_ms, 1000,
        "How often the ingest loop commits a checkpoint: one snapshot "
        "carrying the data AND the CDC source offset in its commit "
        "properties (atomic, exactly-once across restarts)")
    STREAM_INGEST_MAX_BATCH = ConfigOption(
        "stream.ingest.max-batch", int, 1024,
        "Max CDC events pulled from the source per poll; together with "
        "the writer's write.flush.max-bytes budget (which blocks "
        "write_events) this bounds ingest memory — the daemon never "
        "queues events internally")
    STREAM_INGEST_POLL_INTERVAL = ConfigOption(
        "stream.ingest.poll-interval", _parse_duration_ms, 25,
        "Idle sleep between source polls when the source has no events")
    STREAM_COMPACTION_INTERVAL = ConfigOption(
        "stream.compaction.interval", _parse_duration_ms, 2000,
        "How often the compaction loop checks the per-bucket sorted-run "
        "trigger (num-sorted-run.compaction-trigger) and, when over it, "
        "runs a compaction")
    STREAM_COMPACTION_FULL = ConfigOption(
        "stream.compaction.full", _parse_bool, True,
        "Triggered compactions run full (eligible for the mesh engine "
        "with its retry/fallback ladder); false picks incremental "
        "units through the single-chip universal-compaction manager")
    STREAM_MANIFEST_COMPACTION_INTERVAL = ConfigOption(
        "stream.manifest-compaction.interval", _parse_duration_ms,
        60_000,
        "How often the compaction loop probes the manifest "
        "full-compaction trigger (the probe reads the snapshot's "
        "manifest lists — too frequent is wasted metadata IO); "
        "None disables the probe")
    STREAM_COMPACTION_PAUSE_RATIO = ConfigOption(
        "stream.compaction.pause-ratio", float, 0.5,
        "Graceful degradation: the compaction loop SKIPS its round "
        "while the write pipeline's in-flight bytes exceed this "
        "fraction of write.flush.max-bytes (ingest pressure wins)")
    STREAM_COMPACTION_PAUSE_BACKLOG = ConfigOption(
        "stream.compaction.pause-backlog", int, 8192,
        "Also pause compaction while more than this many source events "
        "are waiting to be pulled (ingest is behind)")
    STREAM_SERVE_POLL_INTERVAL = ConfigOption(
        "stream.serve.poll-interval", _parse_duration_ms, 50,
        "Changelog-serving loop sleep between stream-scan polls once "
        "caught up")
    STREAM_SERVE_BUFFER_ROWS = ConfigOption(
        "stream.serve.buffer.rows", int, 65536,
        "Bound on buffered changelog rows awaiting consumers; the "
        "serving loop BLOCKS (backpressure) instead of dropping or "
        "growing without bound when consumers lag")
    STREAM_RESTART_BACKOFF = ConfigOption(
        "stream.restart.backoff", _parse_duration_ms, 200,
        "Base wait before a crashed daemon loop (ingest/compact/serve) "
        "is restarted by its supervisor; waits use capped decorrelated "
        "jitter (utils/backoff.py)")
    STREAM_RESTART_BACKOFF_CAP = ConfigOption(
        "stream.restart.backoff.cap", _parse_duration_ms, 10_000,
        "Cap on the jittered supervised-restart wait")
    STREAM_RESTART_HEALTHY_MS = ConfigOption(
        "stream.restart.healthy-threshold", _parse_duration_ms, 30_000,
        "A loop that ran at least this long counts as healthy and "
        "resets its restart backoff schedule")
    STREAM_RESTART_MAX = ConfigOption(
        "stream.restart.max-restarts", int, None,
        "Give up supervising a loop after this many consecutive "
        "unhealthy restarts (None = restart forever); the daemon "
        "records the terminal error in its status")
    STREAM_EXPIRE_INTERVAL = ConfigOption(
        "stream.expire.interval", _parse_duration_ms, None,
        "When set, the compaction loop also expires old snapshots at "
        "this interval (bounds metadata growth on long-running "
        "daemons); None leaves snapshot expiry to external maintenance")
    # -- multi-host write plane (ours; parallel/multihost.py +
    #    parallel/distributed.py) --------------------------------------------
    MULTIHOST_COMMIT_ARBITRATION = ConfigOption(
        "multihost.commit.arbitration", str, "cas",
        "How concurrent per-process commits publish on a multi-host "
        "mesh (parallel/distributed.py): 'cas' = every process "
        "commits its own messages and the snapshot CAS serializes "
        "them with conflict re-resolution (reference FileStoreCommit "
        "optimistic retry); 'coordinator' = commit messages are "
        "gathered to an elected committer process over the mesh and "
        "published as ONE snapshot per global checkpoint (reference "
        "committer-operator singleton)")
    MULTIHOST_WRITE_ROUTING = ConfigOption(
        "multihost.write.routing", str, "exchange",
        "What a distributed writer does with rows whose "
        "(partition,bucket) is owned by another process: 'exchange' = "
        "reroute them to their owners with one cross-host allgather "
        "per batch (input streams must be DISJOINT across processes); "
        "'spmd' = silently keep only owned rows (every process must "
        "see the IDENTICAL global batch — the SPMD shape); "
        "'local-only' = raise, for pre-partitioned pipelines where a "
        "foreign row is a routing bug")
    MULTIHOST_SCAN_PIN = ConfigOption(
        "multihost.scan.pin-snapshot", _parse_bool, True,
        "Snapshot-consistent cross-host scans: all processes agree on "
        "ONE pinned snapshot id (broadcast from process 0) before "
        "planning, so every host reads the same table version and "
        "split ownership covers exactly one consistent state.  false "
        "= each process plans its own latest snapshot (scans may "
        "straddle concurrent commits)")
    MULTIHOST_LEASE_INTERVAL = ConfigOption(
        "multihost.lease.interval", _parse_duration_ms, 10000,
        "Target lease-renewal cadence of the multi-host maintenance "
        "plane (parallel/maintenance_plane.py): every plane-issued "
        "commit renews the committer's lease as snapshot properties; "
        "when no commit happened within this interval the plane "
        "publishes a small heartbeat snapshot so an idle-but-alive "
        "host is never mistaken for a dead one")
    MULTIHOST_LEASE_TIMEOUT = ConfigOption(
        "multihost.lease.timeout", _parse_duration_ms, 60000,
        "Failure-detector threshold: a maintenance-plane participant "
        "whose newest lease renewal (max-merged over the recent "
        "snapshot chain) is older than this is presumed DEAD, and its "
        "(partition,bucket) groups are deterministically re-assigned "
        "to the survivors (ownership version bump, dead set recorded "
        "in snapshot properties).  Must comfortably exceed "
        "multihost.lease.interval plus worst-case commit latency — a "
        "premature declaration splits ownership of live buckets")
    MULTIHOST_MAINTENANCE_TAKEOVER = ConfigOption(
        "multihost.maintenance.takeover", _parse_bool, True,
        "Whether survivors automatically adopt a dead host's buckets "
        "(compaction, expiry election, changelog serving and — for "
        "distributed stream daemons — its committed CDC offsets, "
        "exactly-once).  false = the failure detector still reports "
        "lease_expired, but ownership stays frozen until an operator "
        "intervenes")
    MULTIHOST_MAINTENANCE_LEASE_WALK = ConfigOption(
        "multihost.maintenance.lease-walk", int, 16,
        "How many recent snapshots the lease reader max-merges to "
        "build the failure-detector view.  One snapshot would race "
        "concurrent committers (each stamps the view IT knew); a "
        "small window resolves the interleaving by max()")
    MULTIHOST_REJOIN_ENABLED = ConfigOption(
        "multihost.rejoin.enabled", _parse_bool, True,
        "Whether a restarted host that the ownership map records DEAD "
        "enters the coordinated rejoin protocol (publish a rejoin "
        "request, wait for the elected survivor to readmit it into a "
        "new ownership generation, replay its offset gap up to the "
        "granted floor, resume).  false refuses the resurrected host: "
        "plane construction raises OwnershipError and rejoin needs an "
        "operator-driven whole-cohort restart")

    LOOKUP_CACHE_MAX_MEMORY_SIZE = ConfigOption(
        "lookup.cache-max-memory-size", parse_memory_size, 256 << 20,
        "Block-cache memory bound of the SST lookup store")
    LOOKUP_CACHE_MAX_DISK_SIZE = ConfigOption(
        "lookup.cache-max-disk-size", parse_memory_size,
        9223372036854775807,
        "Disk bound of the SST lookup store (least recently used files "
        "evict first)")
    BRANCH = ConfigOption("branch", str, "main", "")
    RECORD_LEVEL_EXPIRE_TIME = ConfigOption("record-level.expire-time",
                                            _parse_duration_ms, None, "")
    RECORD_LEVEL_TIME_FIELD = ConfigOption("record-level.time-field", str,
                                           None, "")
    FILE_INDEX_BLOOM_COLUMNS = ConfigOption(
        "file-index.bloom-filter.columns", str, None,
        "Columns to build per-file bloom filters for")
    FILE_INDEX_BLOOM_FPP = ConfigOption(
        "file-index.bloom-filter.fpp", float, 0.01, "")
    FILE_INDEX_IN_MANIFEST_THRESHOLD = ConfigOption(
        "file-index.in-manifest-threshold", parse_memory_size, 500, "")
    FILE_INDEX_BITMAP_COLUMNS = ConfigOption(
        "file-index.bitmap.columns", str, None,
        "Columns to build per-file value->row-position bitmap indexes "
        "for (reference fileindex/bitmap/BitmapFileIndex.java)")
    FILE_INDEX_BSI_COLUMNS = ConfigOption(
        "file-index.bsi.columns", str, None,
        "Integer columns to build per-file bit-sliced indexes for "
        "(reference fileindex/bsi/BitSliceIndexBitmap.java)")
    FILE_INDEX_RANGE_BITMAP_COLUMNS = ConfigOption(
        "file-index.range-bitmap.columns", str, None,
        "Numeric columns to build per-file range-encoded bin bitmaps "
        "for (reference fileindex/rangebitmap/RangeBitmap.java)")
    FILE_INDEX_READ_ENABLED = ConfigOption(
        "file-index.read.enabled", _parse_bool, True,
        "Defined by the reference and read by no scan; refused "
        "(ROADMAP.md A.8.6b)")
    # -- blobs and variant shredding: defined by the reference
    # (options.py:1389-1437) and read by no writer or reader of either
    # package; refused (ROADMAP.md A.8.8b) ----------------------------------
    BLOB_FIELD = ConfigOption(
        "blob-field", str, None,
        "Column stored as .blob sidecar files (auto-detected from the "
        "BLOB type when unset)")
    BLOB_TARGET_FILE_SIZE = ConfigOption(
        "blob.target-file-size", parse_memory_size, None,
        "Roll blob sidecar files at this size (default: "
        "target-file-size)")
    BLOB_AS_DESCRIPTOR = ConfigOption(
        "blob-as-descriptor", _parse_bool, False,
        "Reads return blob descriptors (uri, offset, length) instead "
        "of materialized bytes")
    VARIANT_SHREDDING_SCHEMA = ConfigOption(
        "variant.shreddingSchema", str, None,
        "Explicit shredding paths per variant column, "
        "'col:$.a,$.b;col2:$.x'")
    VARIANT_INFER_SHREDDING_SCHEMA = ConfigOption(
        "variant.inferShreddingSchema", _parse_bool, False,
        "Infer shredded columns from a buffered row sample")
    VARIANT_SHREDDING_MAX_INFER_BUFFER_ROW = ConfigOption(
        "variant.shredding.maxInferBufferRow", int, 1000,
        "Rows sampled for shredding-schema inference")
    VARIANT_SHREDDING_MAX_SCHEMA_DEPTH = ConfigOption(
        "variant.shredding.maxSchemaDepth", int, 5,
        "Max nesting depth of inferred shredded paths")
    VARIANT_SHREDDING_MAX_SCHEMA_WIDTH = ConfigOption(
        "variant.shredding.maxSchemaWidth", int, 50,
        "Max inferred shredded paths per variant column")
    VARIANT_SHREDDING_MIN_FIELD_CARDINALITY_RATIO = ConfigOption(
        "variant.shredding.minFieldCardinalityRatio", float, 0.5,
        "A path must appear in at least this share of sampled rows")
    ROW_TRACKING_ENABLED = ConfigOption("row-tracking.enabled", _parse_bool,
                                        False, "")
    LOCAL_MERGE_BUFFER_SIZE = ConfigOption(
        "local-merge-buffer-size", parse_memory_size, None,
        "Buffer rows before bucket routing and fold duplicate keys to "
        "their winner once this many bytes are buffered (deduplicate "
        "and first-row only)")
    MANIFEST_COMPRESSION = ConfigOption("manifest.compression", str, "zstd", "")

    COMMIT_MAX_RETRIES = ConfigOption(
        "commit.max-retries", int, 10,
        "CAS attempts before the commit raises a conflict")
    COMMIT_MIN_RETRY_WAIT = ConfigOption(
        "commit.min-retry-wait", _parse_duration_ms, 10, "")
    COMMIT_MAX_RETRY_WAIT = ConfigOption(
        "commit.max-retry-wait", _parse_duration_ms, 10_000, "")
    COMMIT_FORCE_CREATE_SNAPSHOT = ConfigOption(
        "commit.force-create-snapshot", _parse_bool, False, "")
    SNAPSHOT_IGNORE_EMPTY_COMMIT = ConfigOption(
        "snapshot.ignore-empty-commit", _parse_bool, None,
        "Skip the snapshot when a commit carries no changes (defaults "
        "on for batch writers, off for streaming exactly-once "
        "progress; reference CoreOptions.java:2497)")


    SCAN_SPLIT_PARALLELISM = ConfigOption(
        "scan.split.parallelism", int, None,
        "Worker threads reading/decoding splits concurrently in the "
        "pipelined scan executor (Arrow C++ decode and file IO release "
        "the GIL); None = min(8, cpu count), 1 = serial read path")
    READ_PREFETCH_SPLITS = ConfigOption(
        "read.prefetch.splits", int, 2,
        "Extra splits submitted beyond the worker pool width so the "
        "next split's files download while the current one merges")
    READ_PREFETCH_MAX_BYTES = ConfigOption(
        "read.prefetch.max-bytes", parse_memory_size, 1 << 30,
        "Hard budget on the estimated bytes (sum of data-file sizes) "
        "of splits in flight at once; at least one split is always "
        "admitted so a budget below one split's size cannot stall")
    READ_RETRY_MAX_ATTEMPTS = ConfigOption(
        "read.retry.max-attempts", int, 3,
        "Attempts per data-file read on a transient store fault (503 "
        "storms, IO errors — parallel/fault.py taxonomy) before the "
        "scan raises; non-transient errors never retry")
    READ_RETRY_BACKOFF = ConfigOption(
        "read.retry.backoff", _parse_duration_ms, 10,
        "Base wait between data-file read retries; actual waits use "
        "capped decorrelated jitter (utils/backoff.py)")
    READ_CACHE_FOOTER = ConfigOption(
        "read.cache.footer", _parse_bool, True,
        "Cache parsed parquet footers of immutable data files in a "
        "process-wide LRU so repeated scans skip metadata decode "
        "(fs/caching.py)")
    READ_CACHE_RANGE = ConfigOption(
        "read.cache.range", _parse_bool, False,
        "Wrap the table's FileIO in the shared byte cache with a "
        "block-range tier keyed by (path, offset, length)")
    READ_CACHE_RANGE_MAX_BYTES = ConfigOption(
        "read.cache.range.max-bytes", parse_memory_size, 128 << 20,
        "Capacity of the block-range cache enabled by read.cache.range")
    READ_DEVICE_DECODE = ConfigOption(
        "read.device-decode", _parse_bool, False,
        "Route parquet data-file reads through the device decode plane "
        "(format/rawpage.py + ops/decode.py): undecoded column-chunk "
        "pages are sliced via ranged reads, and every per-value "
        "transform — RLE/bit-packed level expansion, dictionary "
        "gather, PLAIN reinterpret, null expansion — runs as torch ops "
        "on the table's device; files outside the covered encodings "
        "fall back to the pyarrow host path (counted in "
        "format.rawpage.DECODE_COUNTS)")

    WRITE_FLUSH_PARALLELISM = ConfigOption(
        "write.flush.parallelism", int, None,
        "Worker threads running per-(partition,bucket) flushes (sort + "
        "encode + upload) concurrently in the pipelined write engine; "
        "None = min(8, cpu count), 1 = the serial inline write path")
    WRITE_FLUSH_MAX_BYTES = ConfigOption(
        "write.flush.max-bytes", parse_memory_size, 1 << 30,
        "Hard budget on the estimated buffered bytes of flushes in "
        "flight at once; producers block at write() until the pool "
        "drains below it, and at least one flush is always admitted so "
        "a budget below one buffer's size cannot deadlock")
    WRITE_RETRY_MAX_ATTEMPTS = ConfigOption(
        "write.retry.max-attempts", int, 3,
        "Attempts per bucket flush on a transient store fault (503 "
        "storms, IO errors — parallel/fault.py taxonomy) before the "
        "write raises; non-transient errors never retry, and an "
        "exhausted flush always raises — never silently dropped")
    WRITE_RETRY_BACKOFF = ConfigOption(
        "write.retry.backoff", _parse_duration_ms, 10,
        "Base wait between bucket-flush retries; actual waits use "
        "capped decorrelated jitter (utils/backoff.py)")
    WRITE_STAGE_PARALLELISM = ConfigOption(
        "write.stage.parallelism", int, None,
        "Worker threads uploading staged files (write.stage.dir) "
        "concurrently; None = min(8, cpu count)")

    # -- spill (reference CoreOptions.java:860-930) --------------------------
    SPILL_COMPRESSION = ConfigOption(
        "spill-compression", str, "zstd",
        "Codec for spilled sorted runs (zstd | lz4 | none)")
    SPILL_COMPRESSION_ZSTD_LEVEL = ConfigOption(
        "spill-compression.zstd-level", int, 1,
        "zstd level for spill files (speed matters more than ratio)")
    SORT_SPILL_BUFFER_SIZE = ConfigOption(
        "sort-spill-buffer-size", parse_memory_size, 64 << 20,
        "In-memory rows buffered before a sorted run spills")
    WRITE_BUFFER_SPILL_MAX_DISK_SIZE = ConfigOption(
        "write-buffer-spill.max-disk-size", parse_memory_size,
        9223372036854775807,
        "Disk budget for spilled write-buffer runs; reaching it forces "
        "an early flush to L0 instead of more spill")
    LOCAL_SORT_MAX_NUM_FILE_HANDLES = ConfigOption(
        "local-sort.max-num-file-handles", int, 128,
        "Max spilled runs merged at once; more runs first fold into "
        "one (the reference's external-merge fan-in bound)")


    SCAN_PLAN_SORT_PARTITION = ConfigOption(
        "scan.plan-sort-partition", _parse_bool, False,
        "Sort plan splits by partition value")

    SEQUENCE_FIELD_SORT_ORDER = ConfigOption(
        "sequence.field.sort-order", str, "ascending",
        "ascending: larger sequence wins; descending: smaller wins")

    COMPACTION_TOTAL_SIZE_THRESHOLD = ConfigOption(
        "compaction.total-size-threshold", parse_memory_size, None,
        "Full-compact a bucket whenever its total size is below this")
    COMPACTION_FILE_NUM_LIMIT = ConfigOption(
        "compaction.file-num-limit", int, None,
        "Force a compaction pick once a bucket holds this many files")

    # -- maintenance: snapshot and changelog expiry, partition expiry
    #    and mark-done, tags, callbacks (reference options.py:243-253,
    #    :334-360, :1030-1064, :1269-1271, :1328-1356, :1459-1498) -------
    SNAPSHOT_NUM_RETAINED_MIN = ConfigOption("snapshot.num-retained.min",
                                             int, 10, "")
    SNAPSHOT_NUM_RETAINED_MAX = ConfigOption("snapshot.num-retained.max",
                                             int, 2147483647, "")
    SNAPSHOT_TIME_RETAINED = ConfigOption("snapshot.time-retained",
                                          _parse_duration_ms, 3600000, "")
    SNAPSHOT_EXPIRE_LIMIT = ConfigOption(
        "snapshot.expire.limit", int, 50,
        "Defined by the reference and read by no expiry; refused "
        "(ROADMAP.md A.8.4b)")
    SNAPSHOT_CLEAN_EMPTY_DIRECTORIES = ConfigOption(
        "snapshot.clean-empty-directories", _parse_bool, False,
        "Remove emptied partition/bucket directories after snapshot "
        "expiration")
    DELETE_FILE_THREAD_NUM = ConfigOption(
        "delete-file.thread-num", int, None,
        "Threads for deleting dead files during snapshot expiration "
        "(None = serial)")
    CHANGELOG_NUM_RETAINED_MIN = ConfigOption("changelog.num-retained.min",
                                              int, None, "")
    CHANGELOG_NUM_RETAINED_MAX = ConfigOption("changelog.num-retained.max",
                                              int, None, "")
    CHANGELOG_TIME_RETAINED = ConfigOption(
        "changelog.time-retained", _parse_duration_ms, None,
        "Defined by the reference and read by no expiry, which bounds "
        "decoupled changelogs by count only; refused (ROADMAP.md A.8.4b)")
    PARTITION_EXPIRATION_TIME = ConfigOption("partition.expiration-time",
                                             _parse_duration_ms, None, "")
    PARTITION_EXPIRATION_MAX_NUM = ConfigOption(
        "partition.expiration-max-num", int, 100,
        "Partitions expired per expire_partitions() call, oldest first")
    PARTITION_TIMESTAMP_FORMATTER = ConfigOption(
        "partition.timestamp-formatter", str, None, "")
    PARTITION_TIMESTAMP_PATTERN = ConfigOption(
        "partition.timestamp-pattern", str, None, "")
    PARTITION_MARK_DONE_ACTION = ConfigOption(
        "partition.mark-done-action", str, "success-file",
        "csv of success-file|done-partition|mark-event|http-report|custom")
    PARTITION_MARK_DONE_CUSTOM_CLASS = ConfigOption(
        "partition.mark-done-action.custom.class", str, None,
        "module:Class implementing PartitionMarkDoneAction")
    PARTITION_MARK_DONE_HTTP_URL = ConfigOption(
        "partition.mark-done-action.http.url", str, None, "")
    PARTITION_MARK_DONE_HTTP_PARAMS = ConfigOption(
        "partition.mark-done-action.http.params", str, None, "")
    PARTITION_MARK_DONE_WHEN_END_INPUT = ConfigOption(
        "partition.mark-done-when-end-input", _parse_bool, False, "")
    PARTITION_IDLE_TIME_TO_DONE = ConfigOption(
        "partition.idle-time-to-done", _parse_duration_ms, None, "")
    PARTITION_TIME_INTERVAL = ConfigOption(
        "partition.time-interval", _parse_duration_ms, None, "")
    PARTITION_END_INPUT_TO_DONE = ConfigOption(
        "partition.end-input-to-done", _parse_bool, False,
        "Mark the partitions a batch write touched as done when its "
        "commit lands")
    MANIFEST_FULL_COMPACTION_THRESHOLD = ConfigOption(
        "manifest.full-compaction.threshold", int, 50,
        "Full-rewrite manifests once the chain holds this many small "
        "(sub-half-target-size) manifests (None disables the trigger)")
    INCREMENTAL_BETWEEN_TAG_TO_SNAPSHOT = ConfigOption(
        "incremental-between-tag-to-snapshot", str, None,
        "'tagName,snapshotId': batch-read the deltas from a tag's "
        "snapshot (exclusive) to a snapshot id (inclusive)")
    TAG_AUTOMATIC_CREATION = ConfigOption("tag.automatic-creation", str,
                                          "none", "")
    TAG_CREATION_PERIOD = ConfigOption(
        "tag.creation-period", str, "daily",
        "daily | hourly | two-hours: auto-tag period")
    TAG_CREATION_DELAY = ConfigOption(
        "tag.creation-delay", _parse_duration_ms, 0,
        "Wait this long past the period end before tagging")
    TAG_CREATION_PERIOD_DURATION = ConfigOption(
        "tag.creation-period-duration", _parse_duration_ms, None,
        "Custom period length (overrides tag.creation-period)")
    TAG_PERIOD_FORMATTER = ConfigOption(
        "tag.period-formatter", str, "with_dashes",
        "with_dashes | without_dashes[_colons]: auto-tag name format")
    TAG_NUM_RETAINED_MAX = ConfigOption(
        "tag.num-retained-max", int, None,
        "Oldest auto-tags beyond this count are deleted")
    TAG_DEFAULT_TIME_RETAINED = ConfigOption(
        "tag.default-time-retained", _parse_duration_ms, None,
        "Auto/SQL tags expire after this age")
    TAG_AUTOMATIC_COMPLETION = ConfigOption(
        "tag.automatic-completion", _parse_bool, False,
        "Backfill missed periodic tags, not just the newest period")
    TAG_CREATE_SUCCESS_FILE = ConfigOption(
        "tag.create-success-file", _parse_bool, False,
        "Write a _SUCCESS marker next to each auto-tag")
    TAG_TIME_EXPIRE_ENABLED = ConfigOption(
        "tag.time-expire-enabled", _parse_bool, False,
        "Sweep time-retained tags past expiry at auto-tag time")
    COMMIT_CALLBACKS = ConfigOption(
        "commit.callbacks", str, None,
        "Comma-separated import paths ('pkg.mod:Class') instantiated "
        "and invoked after every successful commit")
    COMMIT_CALLBACK_PARAM = ConfigOption(
        "commit.callback.#.param", str, None,
        "Constructor parameter for the callback class named '#' "
        "(template key: substitute the class path)")
    TAG_CALLBACKS = ConfigOption(
        "tag.callbacks", str, None,
        "Comma-separated import paths invoked after tag creation")
    TAG_CALLBACK_PARAM = ConfigOption(
        "tag.callback.#.param", str, None,
        "Constructor parameter for the tag callback named '#'")
    CHANGELOG_FILE_FORMAT = ConfigOption(
        "changelog-file.format", str, None,
        "Changelog files' format; defaults to file.format")
    CHANGELOG_FILE_COMPRESSION = ConfigOption(
        "changelog-file.compression", str, None,
        "Changelog files' compression; defaults to file.compression")
    CHANGELOG_FILE_PREFIX = ConfigOption("changelog-file.prefix", str,
                                         "changelog-", "")

    SCAN_BOUNDED_WATERMARK = ConfigOption(
        "scan.bounded.watermark", int, None,
        "End a stream once a snapshot watermark passes this bound")
    STREAMING_READ_OVERWRITE = ConfigOption(
        "streaming-read-overwrite", _parse_bool, False,
        "Follow-up scanners also read OVERWRITE snapshots' deltas")
    CONSUMER_IGNORE_PROGRESS = ConfigOption(
        "consumer.ignore-progress", _parse_bool, False,
        "Start fresh instead of resuming the consumer's progress")
    STREAMING_READ_SNAPSHOT_DELAY = ConfigOption(
        "streaming.read.snapshot.delay", _parse_duration_ms, None,
        "Incremental snapshots become visible to streaming reads only "
        "after aging this long (absorbs small out-of-order commits)")


    MANIFEST_TARGET_FILE_SIZE = ConfigOption(
        "manifest.target-file-size", parse_memory_size, 8 << 20, "")
    SCAN_MANIFEST_PARALLELISM = ConfigOption(
        "scan.manifest.parallelism", int, None,
        "Threads for reading manifest files during scan planning "
        "(None = serial)")
    MANIFEST_STATS_SIDECAR = ConfigOption(
        "manifest.stats.sidecar", _parse_bool, True,
        "Write a columnar partition/bucket/key-range stats sidecar "
        "next to every manifest list (vectorized manifest pruning)")
    SCAN_PLAN_CACHE = ConfigOption(
        "scan.plan.cache", _parse_bool, True,
        "Reuse cached plans across snapshots by applying only the new "
        "snapshots' delta manifests (invalidated by overwrites)")
    SCAN_PLAN_CACHE_MAX_ENTRIES = ConfigOption(
        "scan.plan.cache.max-entries", int, 4_000_000,
        "Largest live-entry count the delta-apply plan cache will hold "
        "for one table; bigger tables fall back to cold walks")


    DATA_FILE_PREFIX = ConfigOption(
        "data-file.prefix", str, "data-",
        "File-name prefix of data files")
    DATA_FILE_PATH_DIRECTORY = ConfigOption(
        "data-file.path-directory", str, None,
        "Subdirectory (under the table path) holding data files; "
        "None = partition/bucket directories at the table root")
    FILE_BLOCK_SIZE = ConfigOption(
        "file.block-size", parse_memory_size, None,
        "Format block granularity: parquet row-group bytes / orc "
        "stripe bytes; None = format default")
    TARGET_FILE_ROW_NUM = ConfigOption(
        "target-file-row-num", int, None,
        "Roll data files at this many rows, in addition to "
        "target-file-size")
    FILE_COMPRESSION_PER_LEVEL = ConfigOption(
        "file.compression.per.level", str, None,
        "Per-LSM-level compression overrides, e.g. '0:lz4,5:zstd' — "
        "cheap codec for hot L0, dense for settled levels")

    METADATA_STATS_MODE_PER_LEVEL = ConfigOption(
        "metadata.stats-mode.per.level", str, None,
        "Per-level stats-mode overrides, e.g. '0:none,5:full' — skip "
        "stats work for short-lived L0 files")
    METADATA_STATS_KEEP_FIRST_N_COLUMNS = ConfigOption(
        "metadata.stats-keep-first-n-columns", int, None,
        "Collect file stats only for the first N value columns")


    COMMIT_TIMEOUT = ConfigOption(
        "commit.timeout", _parse_duration_ms, None,
        "Give up CAS retries after this long (None = retries only)")


    def field_default_values(self) -> Dict[str, str]:
        """{column: raw default} from fields.<col>.default-value keys."""
        out = {}
        for k in self.options.keys():
            if k.startswith("fields.") and k.endswith(".default-value"):
                col = k[len("fields."):-len(".default-value")]
                if col and col != "#":
                    out[col] = self.options.get_or(k, None)
        return out


    DATA_FILE_EXTERNAL_PATHS = ConfigOption(
        "data-file.external-paths", str, None,
        "Comma-separated storage roots for NEW data files; readers "
        "follow the per-file external path recorded in the manifest")
    DATA_FILE_EXTERNAL_PATHS_STRATEGY = ConfigOption(
        "data-file.external-paths.strategy",
        _enum("NONE", "ROUND-ROBIN", "SPECIFIC-FS"), "NONE",
        "none: ignore external paths; round-robin: rotate across "
        "them; specific-fs: only roots whose scheme matches "
        "data-file.external-paths.specific-fs")
    DATA_FILE_EXTERNAL_PATHS_SPECIFIC_FS = ConfigOption(
        "data-file.external-paths.specific-fs", str, None,
        "Scheme filter (e.g. 'oss', 's3') for strategy=specific-fs")


    TABLE_READ_SEQUENCE_NUMBER = ConfigOption(
        "table-read.sequence-number.enabled", _parse_bool, False,
        "Expose _SEQUENCE_NUMBER as a metadata column in merge-on-read "
        "scans")
    KV_SEQUENCE_NUMBER_ENABLED = ConfigOption(
        "key-value.sequence_number.enabled", _parse_bool, True,
        "Maintain per-record sequence numbers in the KV plane (false: "
        "arrival order within a commit is the only order)")

    COMPACTION_FORCE_REWRITE_ALL_FILES = ConfigOption(
        "compaction.force-rewrite-all-files", _parse_bool, False,
        "Full compaction rewrites every file even when the bucket is "
        "already a single top-level run (forces DV folding / format "
        "upgrades)")
    COMPACTION_OFFPEAK_START_HOUR = ConfigOption(
        "compaction.offpeak.start.hour", int, -1,
        "Start hour (0-23) of the off-peak window; -1 disables")
    COMPACTION_OFFPEAK_END_HOUR = ConfigOption(
        "compaction.offpeak.end.hour", int, -1,
        "End hour (0-23, exclusive) of the off-peak window; -1 "
        "disables")
    COMPACTION_OFFPEAK_RATIO = ConfigOption(
        "compaction.offpeak-ratio", int, 0,
        "compaction.size-ratio used during off-peak hours (larger = "
        "more aggressive merges while the cluster is idle)")


    def __init__(self, options):
        if isinstance(options, dict):
            options = Options(options)
        self.options: Options = options


    def get(self, option: ConfigOption):
        return self.options.get(option)

    @property
    def bucket(self) -> int:
        return self.options.get(CoreOptions.BUCKET)

    @property
    def dynamic_bucket_target_row_num(self) -> int:
        return self.options.get(CoreOptions.DYNAMIC_BUCKET_TARGET_ROW_NUM)


    @property
    def file_format(self) -> str:
        return self.options.get(CoreOptions.FILE_FORMAT)

    @property
    def file_format_per_level(self):
        """{level: format} overrides (reference
        CoreOptions.fileFormatPerLevel)."""
        v = self.options.get(CoreOptions.FILE_FORMAT_PER_LEVEL)
        out = {}
        if v:
            for part in v.split(","):
                lvl, sep, fmt = part.partition(":")
                if not sep or not fmt.strip() or not lvl.strip():
                    raise ValueError(
                        f"file.format.per.level entry {part!r} must be "
                        f"'<level>:<format>' (e.g. '0:avro,5:parquet')")
                try:
                    level = int(lvl.strip())
                except ValueError:
                    raise ValueError(
                        f"file.format.per.level level {lvl.strip()!r} "
                        f"is not an integer") from None
                out[level] = fmt.strip().lower()
        return out

    @property
    def format_options(self):
        """Raw format-writer tuning options, forwarded to the format SPI
        (reference FileFormat factories receive the full options and
        read their own prefix, e.g. parquet.enable.dictionary).
        file.block-size rides along as the cross-format block/stripe
        granularity."""
        out = {k: v for k, v in self.options._map.items()
               if k.startswith(("parquet.", "orc.", "avro."))}
        bs = self.options.get(CoreOptions.FILE_BLOCK_SIZE)
        if bs is not None:
            out["file.block-size"] = str(bs)
        return out

    @property
    def file_compression_per_level(self):
        """{level: codec} overrides (reference
        CoreOptions.fileCompressionPerLevel)."""
        v = self.options.get(CoreOptions.FILE_COMPRESSION_PER_LEVEL)
        out = {}
        if v:
            for part in v.split(","):
                lvl, sep, codec = part.partition(":")
                if not sep or not codec.strip() or not lvl.strip():
                    raise ValueError(
                        f"file.compression.per.level entry {part!r} "
                        f"must be '<level>:<codec>'")
                out[int(lvl.strip())] = codec.strip().lower()
        return out

    @property
    def stats_mode_per_level(self):
        """{level: stats-mode} overrides (reference
        CoreOptions.statsModePerLevel)."""
        v = self.options.get(CoreOptions.METADATA_STATS_MODE_PER_LEVEL)
        out = {}
        if v:
            for part in v.split(","):
                lvl, sep, mode = part.partition(":")
                if not sep or not mode.strip() or not lvl.strip():
                    raise ValueError(
                        f"metadata.stats-mode.per.level entry {part!r} "
                        f"must be '<level>:<mode>'")
                out[int(lvl.strip())] = mode.strip().lower()
        return out

    def kv_writer_kwargs(self) -> Dict[str, Any]:
        """The per-level / stats / rolling tuning shared by every
        KeyValueFileWriter construction site."""
        return {
            "compression_per_level": self.file_compression_per_level,
            "target_file_row_num": self.options.get(
                CoreOptions.TARGET_FILE_ROW_NUM),
            "stats_mode_per_level": self.stats_mode_per_level,
            "stats_keep_first_n": self.options.get(
                CoreOptions.METADATA_STATS_KEEP_FIRST_N_COLUMNS),
        }

    @property
    def file_compression(self) -> str:
        codec = self.options.get(CoreOptions.FILE_COMPRESSION)
        level = self.options.get(CoreOptions.FILE_COMPRESSION_ZSTD_LEVEL)
        if level is not None and codec == "zstd":
            # "codec:level" spec understood by the format writers
            return f"zstd:{level}"
        return codec

    @property
    def merge_engine(self) -> str:
        return self.options.get(CoreOptions.MERGE_ENGINE)

    @property
    def changelog_producer(self) -> str:
        return self.options.get(CoreOptions.CHANGELOG_PRODUCER)

    @property
    def sequence_field(self):
        v = self.options.get(CoreOptions.SEQUENCE_FIELD)
        return [s.strip() for s in v.split(",")] if v else []

    @property
    def sequence_field_descending(self) -> bool:
        return self.options.get(
            CoreOptions.SEQUENCE_FIELD_SORT_ORDER) == "descending"


    @property
    def changelog_file_format(self) -> str:
        return self.options.get(CoreOptions.CHANGELOG_FILE_FORMAT) or \
            self.file_format

    @property
    def changelog_file_compression(self) -> str:
        return self.options.get(
            CoreOptions.CHANGELOG_FILE_COMPRESSION) or \
            self.file_compression

    @property
    def changelog_file_prefix(self) -> str:
        return self.options.get(CoreOptions.CHANGELOG_FILE_PREFIX)

    @property
    def target_file_size(self) -> int:
        return self.options.get(CoreOptions.TARGET_FILE_SIZE)

    @property
    def write_buffer_size(self) -> int:
        return self.options.get(CoreOptions.WRITE_BUFFER_SIZE)

    @property
    def write_only(self) -> bool:
        return self.options.get(CoreOptions.WRITE_ONLY)

    @property
    def num_sorted_runs_compaction_trigger(self) -> int:
        return self.options.get(CoreOptions.NUM_SORTED_RUNS_COMPACTION_TRIGGER)

    @property
    def num_sorted_runs_stop_trigger(self) -> int:
        v = self.options.get(CoreOptions.NUM_SORTED_RUNS_STOP_TRIGGER)
        if v is None:
            return self.num_sorted_runs_compaction_trigger + 3
        return v

    @property
    def num_levels(self) -> int:
        v = self.options.get(CoreOptions.NUM_LEVELS)
        if v is None:
            return self.num_sorted_runs_compaction_trigger + 1
        return v

    @property
    def max_level(self) -> int:
        """The LSM's top level — the single definition shared by the
        read-optimized view (system.py, iceberg/metadata.py) and the
        sharded compaction/rescale output level."""
        return self.num_levels - 1

    @property
    def max_size_amplification_percent(self) -> int:
        return self.options.get(
            CoreOptions.COMPACTION_MAX_SIZE_AMPLIFICATION_PERCENT)

    @property
    def size_ratio(self) -> int:
        return self.options.get(CoreOptions.COMPACTION_SIZE_RATIO)

    @property
    def file_index_spec(self):
        """index-type name -> column list, for every configured
        file-index kind (consumed by index/file_index.py)."""
        spec = {}
        for name, opt in (
                ("bloom-filter", CoreOptions.FILE_INDEX_BLOOM_COLUMNS),
                ("bitmap", CoreOptions.FILE_INDEX_BITMAP_COLUMNS),
                ("bsi", CoreOptions.FILE_INDEX_BSI_COLUMNS),
                ("range-bitmap",
                 CoreOptions.FILE_INDEX_RANGE_BITMAP_COLUMNS)):
            v = self.options.get(opt)
            cols = [c.strip() for c in v.split(",") if c.strip()] \
                if v else []
            if cols:
                spec[name] = cols
        return spec

    @property
    def branch(self) -> str:
        return self.options.get(CoreOptions.BRANCH)

    @property
    def consumer_id(self):
        return self.options.get(CoreOptions.CONSUMER_ID)

    @property
    def startup_mode(self) -> str:
        mode = self.options.get(CoreOptions.SCAN_MODE)
        if mode == StartupMode.DEFAULT:
            if self.options.get(CoreOptions.SCAN_SNAPSHOT_ID) is not None:
                return StartupMode.FROM_SNAPSHOT
            if self.options.get(CoreOptions.SCAN_TIMESTAMP_MILLIS) is not None:
                return StartupMode.FROM_TIMESTAMP
            if self.options.get(CoreOptions.INCREMENTAL_BETWEEN) is not None:
                return StartupMode.INCREMENTAL
            return StartupMode.LATEST_FULL
        return mode


    @property
    def record_level_expire_time_ms(self):
        return self.options.get(CoreOptions.RECORD_LEVEL_EXPIRE_TIME)

    @property
    def record_level_time_field(self):
        return self.options.get(CoreOptions.RECORD_LEVEL_TIME_FIELD)


    def to_map(self) -> Dict[str, str]:
        return self.options.to_map()
