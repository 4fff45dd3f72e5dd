"""Read-side caches: LRU byte cache, format-footer cache, block-range
cache, and a host-SSD second tier — all over immutable store files.

Counterpart of paimon_tpu/fs/caching.py; a disk-tier entry written by
either package is adopted by the other (the same entry layout).
reference: paimon-common/.../fs/cache/CachingFileIO (local page cache
over remote object stores) + io/cache/CacheManager.java:34; the footer
cache mirrors FileReaderFactory's ParquetFileReader footer reuse (and
"An Empirical Evaluation of Columnar Storage Formats": metadata decode
is the cheapest large win on repeated scans, and footers + hot column
chunks dominate re-read traffic — what the disk tier is sized to
hold).  The disk tier follows "A Host-SSD Collaborative Write
Accelerator for LSM-Tree-Based KV Stores" (arxiv 2410.21760): the
local SSD absorbs object-store round trips on both the read (cache)
and write (staging, parallel/write_pipeline.py) sides.

Tier order on a read: memory LRU -> host-SSD DiskCacheTier -> object
store.  Entries reach the SSD by PROMOTION (cache.disk.promote-after-
hits in-memory hits) or DEMOTION (evicted from the memory LRU under
pressure, or larger than it); a disk hit re-promotes into memory.
Every disk entry is validated by a stored key/length/crc32 header, so
a wiped, truncated or bit-flipped cache dir DEGRADES to the object
store — it can never serve wrong bytes.

Only files whose names mark them immutable (uuid'd data/manifest/index
files, snapshot-N, schema-N) are cached; mutable refs (LATEST/EARLIEST
hints, consumers, tags, branches) always hit the inner FileIO.

Cache observability: every cache reports hits/misses/bytes into the
process metrics registry (metrics.py scan + cache_disk groups) so
benchmarks and dashboards can watch hit rates.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.fs.fileio import FileIO

__all__ = ["CachingFileIO", "FooterCache", "ByteCacheState",
           "DiskCacheTier", "global_footer_cache", "shared_cache_state",
           "shared_disk_tier", "seed_read_cache", "reset_disk_tiers",
           "evict_dropped_file", "footer_cache_disabled",
           "footer_cache_scope", "scoped_batches"]

# snapshot-N files are deliberately NOT cached: rollback_to /
# fast_forward delete and later RECREATE the same snapshot ids with
# different content, which an external writer's mutation would never
# evict from this process's cache. schema-N ids are append-only.
_IMMUTABLE = re.compile(
    r"^(data-|changelog-|manifest-|index-|stats-|schema-\d+$)")


def _cacheable(path: str) -> bool:
    name = path.rstrip("/").rsplit("/", 1)[-1]
    return bool(_IMMUTABLE.search(name))


_COUNTERS = None


def _counters():
    """Scan-group metric Counters resolved ONCE per process (the
    registry group/dict lookups take locks — too heavy per file read)."""
    global _COUNTERS
    if _COUNTERS is None:
        from paimon_tpu_torch import metrics as m
        group = m.global_registry().scan_metrics()
        _COUNTERS = {
            "file_hits": group.counter(m.SCAN_FILE_CACHE_HITS),
            "file_misses": group.counter(m.SCAN_FILE_CACHE_MISSES),
            "footer_hits": group.counter(m.SCAN_FOOTER_CACHE_HITS),
            "footer_misses": group.counter(m.SCAN_FOOTER_CACHE_MISSES),
            "range_hits": group.counter(m.SCAN_RANGE_CACHE_HITS),
            "range_misses": group.counter(m.SCAN_RANGE_CACHE_MISSES),
            "range_hit_bytes": group.counter(
                m.SCAN_RANGE_CACHE_HIT_BYTES),
        }
    return _COUNTERS


_DISK_COUNTERS = None


def _disk_counters():
    """cache_disk-group metrics resolved once per process, like
    _counters()."""
    global _DISK_COUNTERS
    if _DISK_COUNTERS is None:
        from paimon_tpu_torch import metrics as m
        group = m.global_registry().cache_disk_metrics()
        _DISK_COUNTERS = {
            "hits": group.counter(m.CACHE_DISK_HITS),
            "misses": group.counter(m.CACHE_DISK_MISSES),
            "promotions": group.counter(m.CACHE_DISK_PROMOTIONS),
            "demotions": group.counter(m.CACHE_DISK_DEMOTIONS),
            "evictions": group.counter(m.CACHE_DISK_EVICTIONS),
            "bytes": group.gauge(m.CACHE_DISK_BYTES),
        }
    return _DISK_COUNTERS


# -- format footer cache -----------------------------------------------------

class FooterCache:
    """Process-wide LRU of parsed file footers keyed by path.

    Stores opaque parsed-metadata objects (pyarrow.parquet.FileMetaData
    today; any format may join) for immutable-named files only.  Entry
    count bounded, not bytes: a parquet footer is a few KB, so the
    default 4096 entries is ~tens of MB worst case.
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._cache: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, path: str):
        """Cached footer for `path`, or None.  Mutable-named paths and
        thread-locally disabled readers always miss, without touching
        the hit/miss counters."""
        if not _cacheable(path) or not _footer_cache_on():
            return None
        with self._lock:
            md = self._cache.get(path)
            if md is not None:
                self._cache.move_to_end(path)
                self.hits += 1
            else:
                self.misses += 1
        _counters()["footer_hits" if md is not None
                    else "footer_misses"].inc()
        return md

    def put(self, path: str, footer: object):
        if not _cacheable(path) or not _footer_cache_on():
            return
        with self._lock:
            if path not in self._cache:
                self._cache[path] = footer
                while len(self._cache) > self.max_entries:
                    self._cache.popitem(last=False)

    def evict(self, path: str):
        with self._lock:
            self._cache.pop(path, None)

    def clear(self):
        with self._lock:
            self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)


_FOOTERS = FooterCache()
# thread-local off-switch: read paths of tables with read.cache.footer
# = false wrap their format reads in footer_cache_disabled() instead of
# threading a flag through every FormatReader signature
_TLS = threading.local()


def global_footer_cache() -> FooterCache:
    return _FOOTERS


def _footer_cache_on() -> bool:
    return not getattr(_TLS, "off", False)


@contextmanager
def footer_cache_disabled():
    prev = getattr(_TLS, "off", False)
    _TLS.off = True
    try:
        yield
    finally:
        _TLS.off = prev


def scoped_batches(batches, options=None):
    """Drive a read_batches iterator with the footer-cache gate held
    only WHILE ADVANCING it (the footer parse happens on the first
    next()).  Safe inside generators: a plain `with` around a
    yield-containing loop would leak the thread-local flag to
    unrelated reads while the outer generator is suspended, and
    restore it out of order when interleaved generators exit."""
    while True:
        with footer_cache_scope(options):
            try:
                batch = next(batches)
            except StopIteration:
                return
        yield batch


def footer_cache_scope(options=None):
    """Context manager honoring a table's read.cache.footer option —
    the ONE gate every format-read call site wraps (read_kv_file, the
    compaction/mesh rewriters' streamed decodes), so the option's
    contract holds beyond the scan path.  fsck --deep uses
    footer_cache_disabled() directly: verification must reparse the
    on-disk footer regardless of table options."""
    from contextlib import nullcontext

    from paimon_tpu_torch.options import CoreOptions
    if options is not None and \
            not options.get(CoreOptions.READ_CACHE_FOOTER):
        return footer_cache_disabled()
    return nullcontext()


class DiskCacheTier:
    """Size-bounded host-SSD cache of whole-file and block-range
    entries (the second tier under ByteCacheState's memory LRUs).

    Each entry is one file in `directory`: a header (magic + key +
    payload length + crc32) followed by the payload, written to a
    hidden tmp sibling and published by an atomic os.replace under
    the tier lock (no fsync — a cache entry torn by power loss just
    fails validation and degrades).  `get`
    re-validates the header AND the payload crc on every read, so a
    cache dir that was wiped, truncated or bit-flipped mid-run serves
    a miss (degrading to the object store) — never wrong bytes.  Disk
    failures on the put path are swallowed (caching is best-effort);
    the bound is enforced by RESERVING the entry's size under the lock
    before its file is written, so concurrent loads can never overshoot
    cache.disk.max-bytes on disk.

    An existing directory is adopted on construction (entries written
    by an earlier process revalidate on first get), which is what lets
    staged-upload seeding survive restarts."""

    _MAGIC = b"PTC1"
    _HEADER = struct.Struct("<IQI")           # key_len, payload_len, crc

    def __init__(self, directory: str, max_bytes: int):
        self.directory = directory
        self.max_bytes = max(1, int(max_bytes))
        self.lock = threading.Lock()
        # key -> (entry file path, on-disk size); insertion order = LRU
        self._index: "OrderedDict[str, Tuple[str, int]]" = OrderedDict()
        self._by_path: Dict[str, set] = {}
        # keys reserved by an in-flight put whose file is not published
        # yet: get() must report a plain miss for them WITHOUT dropping
        # the reservation (a drop would cancel the concurrent put —
        # under concurrent cold reads of one file, the entry would
        # repeatedly fail to cache)
        self._pending: set = set()
        self.total_bytes = 0
        os.makedirs(directory, exist_ok=True)
        self._adopt()

    # -- keys -----------------------------------------------------------------

    @staticmethod
    def file_key(path: str) -> str:
        return f"F|{path}"

    @staticmethod
    def range_key(path: str, offset: int, length: int) -> str:
        return f"R|{offset}|{length}|{path}"

    @staticmethod
    def _key_path(key: str) -> str:
        """The store path a key belongs to (for per-path eviction)."""
        if key.startswith("R|"):
            return key.split("|", 3)[3]
        return key[2:]

    def _entry_file(self, key: str) -> str:
        import hashlib
        name = hashlib.sha256(key.encode("utf-8")).hexdigest()
        return os.path.join(self.directory, f"{name}.pce")

    # -- adoption -------------------------------------------------------------

    def _adopt(self):
        """Register pre-existing entry files (oldest-mtime first = LRU
        cold end), trusting only their headers here — payload crc is
        checked lazily on get.  Anything unparseable is removed."""
        try:
            all_names = os.listdir(self.directory)
        except OSError:
            return
        names = []
        for n in all_names:
            if n.endswith(".pce"):
                names.append(n)
            elif n.endswith(".tmp"):
                # crash leftovers from a put() killed between fsync and
                # publish: uncounted bytes that would silently breach
                # the max-bytes bound across restarts
                try:
                    os.remove(os.path.join(self.directory, n))
                except OSError:
                    pass
        found = []
        for name in names:
            p = os.path.join(self.directory, name)
            try:
                size = os.path.getsize(p)
                with open(p, "rb") as f:
                    head = f.read(len(self._MAGIC) + self._HEADER.size)
                    if head[:len(self._MAGIC)] != self._MAGIC:
                        raise ValueError("bad magic")
                    key_len, payload_len, _ = self._HEADER.unpack(
                        head[len(self._MAGIC):])
                    key = f.read(key_len).decode("utf-8")
                if size != len(self._MAGIC) + self._HEADER.size + \
                        key_len + payload_len:
                    raise ValueError("bad size")
                found.append((os.path.getmtime(p), key, p, size))
            except (OSError, ValueError, UnicodeDecodeError):
                try:
                    os.remove(p)
                except OSError:
                    pass
        for _, key, p, size in sorted(found):
            # schema-N is the ONE cacheable name that is deterministic
            # (everything else embeds a uuid): a table dropped and
            # recreated at the same path by a process that does not
            # share this cache dir would leave a crc-valid but STALE
            # schema entry — don't let adoption carry that across
            # restarts (a fresh process re-reads schemas once; they
            # are tiny)
            name = self._key_path(key).rstrip("/").rsplit("/", 1)[-1]
            if re.fullmatch(r"schema-\d+", name):
                try:
                    os.remove(p)
                except OSError:
                    pass
                continue
            self._index[key] = (p, size)
            self._by_path.setdefault(self._key_path(key), set()).add(key)
            self.total_bytes += size
        with self.lock:
            self._evict_over_bound()
        _disk_counters()["bytes"].set(self.total_bytes)

    # -- reads ----------------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        """The entry's payload, or None.  Validation failure (missing
        file, torn header, wrong key, length or crc mismatch) drops the
        entry and reports a miss — the caller falls through to the
        next tier."""
        with self.lock:
            entry = self._index.get(key)
            pending = key in self._pending
            if entry is not None:
                self._index.move_to_end(key)
        c = _disk_counters()
        if entry is None or pending:
            # pending = a concurrent put reserved the key but has not
            # published its file yet: a plain miss, NOT a drop
            c["misses"].inc()
            return None
        p, _ = entry
        try:
            with open(p, "rb") as f:
                blob = f.read()
            off = len(self._MAGIC)
            if blob[:off] != self._MAGIC:
                raise ValueError("bad magic")
            key_len, payload_len, crc = self._HEADER.unpack(
                blob[off:off + self._HEADER.size])
            off += self._HEADER.size
            stored_key = blob[off:off + key_len].decode("utf-8")
            payload = blob[off + key_len:]
            if stored_key != key or len(payload) != payload_len or \
                    zlib.crc32(payload) != crc:
                raise ValueError("validation failed")
        except (OSError, ValueError, UnicodeDecodeError, struct.error):
            # stale/corrupt/wiped entry: degrade to the next tier
            self._drop(key)
            c["evictions"].inc()
            c["misses"].inc()
            return None
        c["hits"].inc()
        return payload

    # -- writes ---------------------------------------------------------------

    def put(self, key: str, data: bytes) -> bool:
        """Best-effort insert; True when the entry landed.  The bound
        is airtight under concurrency: size is RESERVED under the lock
        before any byte is written, the payload lands in a hidden tmp
        sibling, and the atomic publish (os.replace) happens back under
        the lock only if the reservation still stands — an entry file
        can never exist on disk without its bytes being accounted, so
        the sum of entry files never exceeds max_bytes.  Any disk
        failure un-reserves and returns False (never raises into a
        read/write hot path)."""
        import uuid
        key_bytes = key.encode("utf-8")
        size = len(self._MAGIC) + self._HEADER.size + len(key_bytes) + \
            len(data)
        if size > self.max_bytes:
            return False
        c = _disk_counters()
        with self.lock:
            if key in self._index:
                self._index.move_to_end(key)
                return False
            self.total_bytes += size
            self._evict_over_bound()
            p = self._entry_file(key)
            self._index[key] = (p, size)
            self._pending.add(key)
            self._by_path.setdefault(self._key_path(key), set()).add(key)
        header = self._MAGIC + self._HEADER.pack(
            len(key_bytes), len(data), zlib.crc32(data)) + key_bytes
        tmp = os.path.join(self.directory,
                           f".{uuid.uuid4().hex}.tmp")

        def _write_tmp():
            # deliberately NO fsync: this is a CACHE, not a durability
            # tier — the tmp+replace gives concurrent readers
            # atomicity, and an entry torn by power loss just fails
            # its crc validation on get() and degrades to the store.
            # (Staged UPLOADS fsync — their retry contract needs the
            # bytes.)  Header and payload are written separately so a
            # multi-MB seed never pays a full concatenation copy.
            with open(tmp, "wb") as f:
                f.write(header)
                f.write(data)

        try:
            _write_tmp()
        except OSError:
            # cache dir gone/unwritable mid-run: recreate once, else
            # degrade (drop the reservation, caching stays best-effort)
            try:
                os.makedirs(self.directory, exist_ok=True)
                _write_tmp()
            except OSError:
                self._drop(key)
                return False
        published = False
        try:
            with self.lock:
                live = self._index.get(key)
                if live is not None and live[0] == p:
                    # publish only while the reservation stands (the
                    # entry may have been evicted/dropped mid-write)
                    os.replace(tmp, p)
                    published = True
                self._pending.discard(key)
        except OSError:
            with self.lock:
                self._pending.discard(key)
        if not published:
            try:
                os.remove(tmp)
            except OSError:
                pass
            self._drop(key)
            return False
        c["bytes"].set(self.total_bytes)
        return True

    def _evict_over_bound(self):
        """Lock held: drop cold entries until total <= max_bytes.
        Entries whose put is still writing its file are protected by
        never evicting the key being reserved (it is appended last)."""
        c = _disk_counters()
        while self.total_bytes > self.max_bytes and self._index:
            key, (p, size) = self._index.popitem(last=False)
            self._by_path.get(self._key_path(key), set()).discard(key)
            self.total_bytes -= size
            try:
                os.remove(p)
            # lint-ok: fault-taxonomy eviction sweep, not a retry:
            # each iteration pops a DIFFERENT entry (popitem
            # guarantees progress) and a vanished file is the desired
            # end state of an eviction
            except OSError:
                pass
            c["evictions"].inc()
        c["bytes"].set(self.total_bytes)

    def _drop(self, key: str):
        # file removal stays UNDER the lock (like _evict_over_bound):
        # an outside-the-lock remove could race a re-put that just
        # republished the same deterministic entry path
        with self.lock:
            entry = self._index.pop(key, None)
            self._pending.discard(key)
            if entry is None:
                return
            p, size = entry
            self._by_path.get(self._key_path(key), set()).discard(key)
            self.total_bytes -= size
            try:
                os.remove(p)
            except OSError:
                pass
        _disk_counters()["bytes"].set(self.total_bytes)

    def evict_path(self, path: str):
        """Drop every entry (whole-file + all ranges) of `path` — the
        snapshot-advance / mutation invalidation hook."""
        evicted = 0
        with self.lock:
            keys = list(self._by_path.pop(path, ()))
            for key in keys:
                entry = self._index.pop(key, None)
                if entry is not None:
                    self.total_bytes -= entry[1]
                    try:
                        os.remove(entry[0])
                    except OSError:
                        pass
                    evicted += 1
        c = _disk_counters()
        if evicted:
            c["evictions"].inc(evicted)
        c["bytes"].set(self.total_bytes)

    def clear(self):
        with self.lock:
            for p, _ in self._index.values():
                try:
                    os.remove(p)
                except OSError:
                    pass
            self._index.clear()
            self._by_path.clear()
            self._pending.clear()
            self.total_bytes = 0
        _disk_counters()["bytes"].set(0)

    def __len__(self) -> int:
        return len(self._index)


class ByteCacheState:
    """The mutable LRU state behind CachingFileIO — whole-file cache,
    block-range cache, sizes, hit/miss counts and the lock — separable
    from the wrapper so MANY FileIO wrappers (every FileStoreTable
    instance that `table.copy()` or the query service creates) can
    share ONE process-wide, size-bounded tier.  A wrapper built without
    an explicit state keeps a private one (the legacy per-instance
    scope)."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 range_cache_bytes: int = 0):
        self.capacity = capacity_bytes
        self.range_capacity = range_cache_bytes
        self.lock = threading.Lock()
        self.cache: "OrderedDict[str, bytes]" = OrderedDict()
        self.size = 0
        self.ranges: "OrderedDict[Tuple[str, int, int], bytes]" = \
            OrderedDict()
        self.range_size = 0
        self.hits = 0
        self.misses = 0
        self.range_hits = 0
        self.range_misses = 0
        # host-SSD second tier (cache.disk.*): None = memory-only.
        # hit counts drive hit-earned promotion; pruned with entries.
        self.disk: Optional[DiskCacheTier] = None
        self.promote_hits = 2
        self._hit_counts: Dict[object, int] = {}

    def grow_to(self, capacity_bytes: int, range_cache_bytes: int):
        """Capacities of a shared state only ever GROW to the largest
        request: one table configuring a bigger cache must not shrink
        (and thereby flush) the tier under every other table."""
        with self.lock:
            self.capacity = max(self.capacity, capacity_bytes)
            self.range_capacity = max(self.range_capacity,
                                      range_cache_bytes)

    def attach_disk(self, tier: DiskCacheTier,
                    promote_hits: Optional[int] = None):
        """Attach (or grow) the host-SSD tier under this state's memory
        LRUs.  First tier attached wins; a later attach with the same
        tier only grows its bound (shared_disk_tier handles per-dir
        identity) — swapping directories mid-run is not supported."""
        with self.lock:
            if self.disk is None:
                self.disk = tier
            if promote_hits is not None:
                self.promote_hits = max(1, int(promote_hits))

    def note_hit(self, key) -> bool:
        """Lock held: count one in-memory hit of `key`; True when the
        count just reached the promotion threshold (the caller writes
        the entry to the disk tier OUTSIDE the lock, once)."""
        if self.disk is None:
            return False
        n = self._hit_counts.get(key, 0) + 1
        self._hit_counts[key] = n
        return n == self.promote_hits

    def demote(self, demoted):
        """Write memory-evicted [(key, bytes)] entries to the disk tier
        (outside the state lock).  Keys are whole-file path strings or
        (path, offset, length) range tuples."""
        if self.disk is None or not demoted:
            return
        c = _disk_counters()
        for key, data in demoted:
            dkey = self.disk.file_key(key) if isinstance(key, str) \
                else self.disk.range_key(*key)
            if self.disk.put(dkey, data):
                c["demotions"].inc()

    def evict_path(self, path: str):
        """Drop every entry (whole-file + all ranges) for `path` —
        mutation invalidation and the serving plane's snapshot-advance
        eviction of files dropped by compaction both land here.  The
        disk tier is evicted too (both tiers drop on snapshot advance)."""
        with self.lock:
            data = self.cache.pop(path, None)
            if data is not None:
                self.size -= len(data)
            self._hit_counts.pop(path, None)
            for key in [k for k in self.ranges if k[0] == path]:
                self.range_size -= len(self.ranges.pop(key))
                self._hit_counts.pop(key, None)
            disk = self.disk
        if disk is not None:
            disk.evict_path(path)

    def clear(self):
        with self.lock:
            self.cache.clear()
            self.ranges.clear()
            self.size = self.range_size = 0
            self._hit_counts.clear()
            disk = self.disk
        if disk is not None:
            disk.clear()


_SHARED_STATE: Optional[ByteCacheState] = None
_SHARED_STATE_LOCK = threading.Lock()


def shared_cache_state(capacity_bytes: int = 0,
                       range_cache_bytes: int = 0) -> ByteCacheState:
    """THE process-wide byte-cache tier (the cross-request promotion of
    the per-read CachingFileIO scope): every caller gets the same
    ByteCacheState, sized to the largest capacities ever requested, so
    all concurrent /scan, /lookup and /changelog requests — and every
    `table.copy()` — warm one shared, size-bounded cache."""
    global _SHARED_STATE
    with _SHARED_STATE_LOCK:
        if _SHARED_STATE is None:
            _SHARED_STATE = ByteCacheState(capacity_bytes,
                                           range_cache_bytes)
        else:
            _SHARED_STATE.grow_to(capacity_bytes, range_cache_bytes)
        return _SHARED_STATE


_DISK_TIERS: Dict[str, DiskCacheTier] = {}
_DISK_TIERS_LOCK = threading.Lock()


def shared_disk_tier(directory: str, max_bytes: int) -> DiskCacheTier:
    """THE process-wide DiskCacheTier for `directory` (one tier per
    cache dir per process — concurrent tiers over one dir would fight
    over the same entry files).  Like shared_cache_state, the bound
    only grows to the largest request."""
    key = os.path.realpath(directory)
    with _DISK_TIERS_LOCK:
        tier = _DISK_TIERS.get(key)
        if tier is None:
            tier = DiskCacheTier(directory, max_bytes)
            _DISK_TIERS[key] = tier
        else:
            with tier.lock:
                tier.max_bytes = max(tier.max_bytes, max(1, int(max_bytes)))
        return tier


def reset_disk_tiers():
    """Detach the disk tier from the shared state and forget every
    registered tier (tests: a tmpdir-backed tier must not outlive its
    test and resurrect deleted directories)."""
    with _DISK_TIERS_LOCK:
        _DISK_TIERS.clear()
    if _SHARED_STATE is not None:
        with _SHARED_STATE.lock:
            _SHARED_STATE.disk = None
            _SHARED_STATE._hit_counts.clear()


def seed_read_cache(path: str, data: bytes,
                    state: Optional[ByteCacheState] = None):
    """Seed the read tier with a just-uploaded file's bytes
    (UploadStager calls this after the object store acked): per arxiv
    2410.21760 newly written files are the hottest reads — compaction,
    changelog serving and fresh scans re-read them immediately, and the
    SSD copy spares the round trip.  Lands in the disk tier only (not
    the memory LRU, which hot scan state owns).  `state` is the
    writer's own cache state when its FileIO is a CachingFileIO (a
    table on a PRIVATE state must seed the tier it actually reads);
    defaults to the shared state.  No-op when no disk tier is
    attached."""
    st = state if state is not None else _SHARED_STATE
    if st is None or st.disk is None or not _cacheable(path):
        return
    if st.disk.put(st.disk.file_key(path), data):
        _disk_counters()["promotions"].inc()


def evict_dropped_file(path: str):
    """Snapshot-advance invalidation: a data file dropped by compaction
    or expiry can never be planned again, so its footer and any shared
    byte-cache entries (memory AND host-SSD tier) are dead weight —
    evict them eagerly instead of waiting for LRU pressure.
    (Correctness never depends on this: only immutable-named files are
    cached.)"""
    if _SHARED_STATE is not None:
        _SHARED_STATE.evict_path(path)
    _FOOTERS.evict(path)


class CachingFileIO(FileIO):
    """LRU whole-file byte cache, plus an optional block-range cache
    keyed by (path, offset, length) for formats that read footers/blobs
    by range (mosaic) instead of whole files.  The range cache only
    serves immutable files NOT already in the whole-file cache (a
    whole-file hit slices for free).

    Pass `state=shared_cache_state(...)` to join the process-wide tier
    (cross-request/cross-instance sharing); without it the wrapper
    keeps a private state, the legacy scope."""

    def __init__(self, inner: FileIO, capacity_bytes: int = 256 << 20,
                 range_cache_bytes: int = 0,
                 state: Optional[ByteCacheState] = None):
        self.inner = inner
        if state is not None:
            state.grow_to(capacity_bytes, range_cache_bytes)
            self.state = state
        else:
            self.state = ByteCacheState(capacity_bytes,
                                        range_cache_bytes)

    # counters/capacities read by tests and benchmarks; shared-state
    # wrappers deliberately report the TIER's numbers
    @property
    def capacity(self) -> int:
        return self.state.capacity

    @property
    def range_capacity(self) -> int:
        return self.state.range_capacity

    @property
    def hits(self) -> int:
        return self.state.hits

    @property
    def misses(self) -> int:
        return self.state.misses

    @property
    def range_hits(self) -> int:
        return self.state.range_hits

    @property
    def range_misses(self) -> int:
        return self.state.range_misses

    # -- cached reads --------------------------------------------------------

    def _promote(self, key, data: bytes):
        """Hit-earned memory->disk promotion (outside the state lock)."""
        st = self.state
        dkey = st.disk.file_key(key) if isinstance(key, str) \
            else st.disk.range_key(*key)
        if st.disk.put(dkey, data):
            _disk_counters()["promotions"].inc()

    def _mem_insert(self, path: str, data: bytes):
        """Insert into the whole-file memory LRU; overflow evictions
        (and entries larger than the memory capacity) DEMOTE to the
        disk tier instead of vanishing."""
        st = self.state
        demoted = []
        if len(data) <= st.capacity:
            with st.lock:
                if path not in st.cache:
                    st.cache[path] = data
                    st.size += len(data)
                    while st.size > st.capacity and st.cache:
                        k, old = st.cache.popitem(last=False)
                        st.size -= len(old)
                        st._hit_counts.pop(k, None)
                        demoted.append((k, old))
        elif st.disk is not None:
            demoted.append((path, data))
        st.demote(demoted)

    def read_bytes(self, path: str) -> bytes:
        if not _cacheable(path):
            return self.inner.read_bytes(path)
        st = self.state
        promote = False
        with st.lock:
            data = st.cache.get(path)
            if data is not None:
                st.cache.move_to_end(path)
                st.hits += 1
                promote = st.note_hit(path)
        if data is not None:
            _counters()["file_hits"].inc()
            if promote:
                self._promote(path, data)
            return data
        if st.disk is not None:
            # memory miss: the host-SSD tier answers before the object
            # store, and a hit re-promotes into the memory LRU.  A
            # disk-served read counts as a file-cache HIT in the scan
            # group (hit-ratio math must see tier-2 hits, not report a
            # fully-SSD-warm workload as all-cold)
            data = st.disk.get(st.disk.file_key(path))
            if data is not None:
                _counters()["file_hits"].inc()
                self._mem_insert(path, data)
                return data
        data = self.inner.read_bytes(path)
        with st.lock:
            st.misses += 1
        _counters()["file_misses"].inc()
        self._mem_insert(path, data)
        return data

    def _range_get(self, path: str, offset: int,
                   length: int) -> Optional[bytes]:
        key = (path, offset, length)
        st = self.state
        promote = False
        with st.lock:
            data = st.ranges.get(key)
            if data is not None:
                st.ranges.move_to_end(key)
                st.range_hits += 1
                promote = st.note_hit(key)
        if promote and data is not None:
            self._promote(key, data)
        return data

    def _range_put(self, path: str, offset: int, length: int,
                   data: bytes):
        st = self.state
        demoted = []
        key = (path, offset, length)
        if len(data) > st.range_capacity:
            if st.disk is not None:
                demoted.append((key, data))
            st.demote(demoted)
            return
        with st.lock:
            if key not in st.ranges:
                st.ranges[key] = data
                st.range_size += len(data)
                while st.range_size > st.range_capacity and \
                        st.ranges:
                    k, old = st.ranges.popitem(last=False)
                    st.range_size -= len(old)
                    st._hit_counts.pop(k, None)
                    demoted.append((k, old))
        st.demote(demoted)

    def _range_caching(self) -> bool:
        """Whether ranged reads should consult/populate the range
        caches at all: a memory range LRU is configured OR a disk tier
        (which holds range entries regardless of the memory capacity)."""
        st = self.state
        return st.range_capacity > 0 or st.disk is not None

    def _disk_range_get(self, path: str, offset: int,
                        length: int) -> Optional[bytes]:
        """SSD fallbacks for one range: the exact range entry first,
        then a whole-file disk entry (staged-upload seeds land as
        whole files) sliced for the request.  With a retaining memory
        LRU (capacity > 0) the whole file re-promotes to memory; with
        the range-only shape the served SLICE is cached as a range
        entry instead, so each distinct range pays the full-entry read
        at most once — never a quadratic re-read of a big entry per
        few-KB range, and never a seed that range readers can't
        reach."""
        st = self.state
        if st.disk is None:
            return None
        data = st.disk.get(st.disk.range_key(path, offset, length))
        if data is not None:
            if st.range_capacity > 0:
                self._range_put(path, offset, length, data)
            return data
        whole = st.disk.get(st.disk.file_key(path))
        if whole is not None:
            data = whole[offset:offset + length]
            if st.capacity > 0:
                self._mem_insert(path, whole)
            else:
                self._range_put(path, offset, length, data)
            return data
        return None

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        st = self.state
        if _cacheable(path):
            promote = False
            with st.lock:
                data = st.cache.get(path)
                if data is not None:
                    st.cache.move_to_end(path)
                    st.hits += 1
                    promote = st.note_hit(path)
            if data is not None:
                if promote:
                    self._promote(path, data)
                return data[offset:offset + length]
            if self._range_caching():
                data = self._range_get(path, offset, length)
                if data is None:
                    data = self._disk_range_get(path, offset, length)
                if data is not None:
                    c = _counters()
                    c["range_hits"].inc()
                    c["range_hit_bytes"].inc(len(data))
                    return data
        # not cached: delegate the range — never force a full-object GET
        with st.lock:
            st.misses += 1
        data = self.inner.read_range(path, offset, length)
        if self._range_caching() and _cacheable(path):
            with st.lock:
                st.range_misses += 1
            _counters()["range_misses"].inc()
            self._range_put(path, offset, length, data)
        return data

    def read_ranges(self, path: str,
                    ranges: List[Tuple[int, int]]) -> List[bytes]:
        """Vectored read through the caches: cached ranges are served
        locally (memory, then SSD), the remaining ones go to the inner
        FileIO in ONE vectored call (object stores coalesce them).
        Counts into the same hit/miss/byte counters as the scalar
        path."""
        st = self.state
        if not _cacheable(path) or \
                (not self._range_caching() and path not in st.cache):
            return self.inner.read_ranges(path, ranges)
        out: List[Optional[bytes]] = [None] * len(ranges)
        missing: List[int] = []
        c = _counters()
        promote = False
        with st.lock:
            whole = st.cache.get(path)
            if whole is not None:
                st.cache.move_to_end(path)
                st.hits += 1            # ONE hit per vectored call,
                promote = st.note_hit(path)
        if whole is not None:           # like read_bytes would count
            c["file_hits"].inc()
            if promote:
                self._promote(path, whole)
            return [whole[o:o + ln] for o, ln in ranges]
        if st.disk is not None:
            whole = st.disk.get(st.disk.file_key(path))
            if whole is not None:
                if st.capacity > 0:
                    self._mem_insert(path, whole)
                else:
                    # range-only memory shape: cache the served slices
                    # so later calls hit range entries instead of
                    # re-reading the full SSD entry
                    for o, ln in ranges:
                        self._range_put(path, o, ln, whole[o:o + ln])
                c["file_hits"].inc()    # one per vectored call, like
                return [whole[o:o + ln]  # the memory whole-file branch
                        for o, ln in ranges]
        for i, (offset, length) in enumerate(ranges):
            got = None
            if self._range_caching():
                got = self._range_get(path, offset, length)
                if got is None:
                    # same SSD fallback ladder as the scalar path:
                    # exact range entry, then a whole-file seed sliced
                    got = self._disk_range_get(path, offset, length)
            if got is not None:
                c["range_hits"].inc()
                c["range_hit_bytes"].inc(len(got))
                out[i] = got
            else:
                missing.append(i)
        if missing:
            fetched = self.inner.read_ranges(
                path, [ranges[i] for i in missing])
            for i, data in zip(missing, fetched):
                out[i] = data
                if self._range_caching():
                    with st.lock:
                        st.range_misses += 1
                    c["range_misses"].inc()
                    self._range_put(path, ranges[i][0], ranges[i][1],
                                    data)
        return out  # type: ignore[return-value]

    # -- invalidating mutations ---------------------------------------------

    def _evict(self, path: str):
        self.state.evict_path(path)
        _FOOTERS.evict(path)

    def write_bytes(self, path, data, overwrite=True):
        self._evict(path)
        return self.inner.write_bytes(path, data, overwrite=overwrite)

    def try_to_write_atomic(self, path, data):
        self._evict(path)
        return self.inner.try_to_write_atomic(path, data)

    def delete(self, path, recursive=False):
        self._evict(path)
        return self.inner.delete(path, recursive=recursive)

    def rename(self, src, dst):
        self._evict(src)
        self._evict(dst)
        return self.inner.rename(src, dst)

    # -- delegation ----------------------------------------------------------

    def exists(self, path):
        return self.inner.exists(path)

    def get_file_size(self, path):
        return self.inner.get_file_size(path)

    def list_status(self, path):
        return self.inner.list_status(path)

    def mkdirs(self, path):
        return self.inner.mkdirs(path)

    def is_object_store(self):
        return self.inner.is_object_store()
