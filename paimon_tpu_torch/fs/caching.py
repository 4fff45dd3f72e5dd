"""Read-side caches over immutable store files: the process-wide
format-footer cache and the shared byte-cache tier (whole files and
block ranges) behind `CachingFileIO`.

Counterpart of paimon_tpu/fs/caching.py without its host-SSD second
tier (`DiskCacheTier`, `shared_disk_tier`, cache.disk.*) and the
upload seeding that only feeds that tier (`seed_read_cache`); they wait
for ROADMAP.md A.7b.  reference: FileReaderFactory's ParquetFileReader
footer reuse, fs/cache/CachingFileIO.  Only files whose names mark them
immutable (uuid'd data/manifest/index files, schema-N) are cached;
hits and misses count into the scan metric group.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from typing import List, Optional, Tuple

from paimon_tpu_torch.fs.fileio import FileIO

__all__ = ["FooterCache", "global_footer_cache", "footer_cache_disabled",
           "footer_cache_scope", "scoped_batches", "ByteCacheState",
           "CachingFileIO", "shared_cache_state", "evict_dropped_file"]

# snapshot-N files are deliberately NOT cached: rollback_to /
# fast_forward delete and later recreate the same snapshot ids with
# different content; schema-N ids are append-only
_IMMUTABLE = re.compile(
    r"^(data-|changelog-|manifest-|index-|stats-|schema-\d+$)")


def _cacheable(path: str) -> bool:
    return bool(_IMMUTABLE.match(path.rsplit("/", 1)[-1]))


_COUNTERS = None


def _counters():
    """Scan-group counters, resolved once per process (registry lookups
    take locks: too heavy per file read)."""
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


class FooterCache:
    """Process-wide LRU of parsed file footers keyed by path.

    Stores opaque parsed-metadata objects (pyarrow.parquet.FileMetaData)
    for immutable-named files only.  Entry count bounded, not bytes: a
    parquet footer is a few KB."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._cache: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, path: str):
        """Cached footer for `path`, or None.  Mutable-named paths and
        thread-locally disabled readers always miss, without touching
        the hit/miss counts."""
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


_FOOTERS = FooterCache()
# thread-local off-switch: read paths of tables with read.cache.footer
# = false wrap their format reads in footer_cache_disabled()
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
    only while advancing it (the footer parse happens on the first
    next()): a `with` around a yield-containing loop would leak the
    thread-local flag to unrelated reads while the outer generator is
    suspended."""
    while True:
        with footer_cache_scope(options):
            try:
                batch = next(batches)
            except StopIteration:
                return
        yield batch


def footer_cache_scope(options=None):
    """Context manager honoring a table's read.cache.footer option —
    the one gate every format-read call site wraps."""
    from paimon_tpu_torch.options import CoreOptions
    if options is not None and \
            not options.get(CoreOptions.READ_CACHE_FOOTER):
        return footer_cache_disabled()
    return nullcontext()


class ByteCacheState:
    """The LRU state behind CachingFileIO (whole-file cache, block-range
    cache, sizes, counts, lock), separable from the wrapper so that many
    wrappers (every table the query service rewraps) share one
    process-wide, size-bounded tier."""

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

    def grow_to(self, capacity_bytes: int, range_cache_bytes: int):
        """Capacities only grow to the largest request: one table asking
        for a bigger cache must not shrink (and so flush) the tier under
        every other table."""
        with self.lock:
            self.capacity = max(self.capacity, capacity_bytes)
            self.range_capacity = max(self.range_capacity,
                                      range_cache_bytes)

    def evict_path(self, path: str):
        """Drop every entry of `path` (whole file and all ranges)."""
        with self.lock:
            data = self.cache.pop(path, None)
            if data is not None:
                self.size -= len(data)
            for key in [k for k in self.ranges if k[0] == path]:
                self.range_size -= len(self.ranges.pop(key))



_SHARED_STATE: Optional[ByteCacheState] = None
_SHARED_STATE_LOCK = threading.Lock()


def shared_cache_state(capacity_bytes: int = 0,
                       range_cache_bytes: int = 0) -> ByteCacheState:
    """The process-wide byte-cache tier: every caller gets the same
    state, sized to the largest capacities ever requested."""
    global _SHARED_STATE
    with _SHARED_STATE_LOCK:
        if _SHARED_STATE is None:
            _SHARED_STATE = ByteCacheState(capacity_bytes,
                                           range_cache_bytes)
        else:
            _SHARED_STATE.grow_to(capacity_bytes, range_cache_bytes)
        return _SHARED_STATE


def evict_dropped_file(path: str):
    """A data file dropped by compaction can never be planned again:
    evict its shared byte-cache entries and its footer at once instead
    of waiting for LRU pressure (correctness never depends on this:
    only immutable files are cached)."""
    if _SHARED_STATE is not None:
        _SHARED_STATE.evict_path(path)
    _FOOTERS.evict(path)


class CachingFileIO(FileIO):
    """LRU whole-file byte cache, plus a block-range cache keyed by
    (path, offset, length) for ranged reads of files not cached whole.
    Pass `state=shared_cache_state(...)` to join the process-wide tier;
    without it the wrapper keeps a private state."""

    def __init__(self, inner: FileIO, capacity_bytes: int = 256 << 20,
                 range_cache_bytes: int = 0,
                 state: Optional[ByteCacheState] = None):
        self.inner = inner
        if state is not None:
            state.grow_to(capacity_bytes, range_cache_bytes)
            self.state = state
        else:
            self.state = ByteCacheState(capacity_bytes, range_cache_bytes)

    # -- cached reads --------------------------------------------------------

    def _mem_insert(self, path: str, data: bytes):
        st = self.state
        if len(data) > st.capacity:
            return
        with st.lock:
            if path not in st.cache:
                st.cache[path] = data
                st.size += len(data)
                while st.size > st.capacity and st.cache:
                    _, old = st.cache.popitem(last=False)
                    st.size -= len(old)

    def read_bytes(self, path: str) -> bytes:
        if not _cacheable(path):
            return self.inner.read_bytes(path)
        st = self.state
        with st.lock:
            data = st.cache.get(path)
            if data is not None:
                st.cache.move_to_end(path)
        if data is not None:
            _counters()["file_hits"].inc()
            return data
        data = self.inner.read_bytes(path)
        _counters()["file_misses"].inc()
        self._mem_insert(path, data)
        return data

    def _range_get(self, path: str, offset: int,
                   length: int) -> Optional[bytes]:
        key = (path, offset, length)
        st = self.state
        with st.lock:
            data = st.ranges.get(key)
            if data is not None:
                st.ranges.move_to_end(key)
        return data

    def _range_put(self, path: str, offset: int, length: int,
                   data: bytes):
        st = self.state
        if len(data) > st.range_capacity:
            return
        key = (path, offset, length)
        with st.lock:
            if key not in st.ranges:
                st.ranges[key] = data
                st.range_size += len(data)
                while st.range_size > st.range_capacity and st.ranges:
                    _, old = st.ranges.popitem(last=False)
                    st.range_size -= len(old)

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        st = self.state
        if _cacheable(path):
            with st.lock:
                data = st.cache.get(path)
                if data is not None:
                    st.cache.move_to_end(path)
            if data is not None:
                _counters()["file_hits"].inc()
                return data[offset:offset + length]
            if st.range_capacity > 0:
                data = self._range_get(path, offset, length)
                if data is not None:
                    c = _counters()
                    c["range_hits"].inc()
                    c["range_hit_bytes"].inc(len(data))
                    return data
        # not cached: delegate the range, never a whole-object read
        data = self.inner.read_range(path, offset, length)
        if st.range_capacity > 0 and _cacheable(path):
            _counters()["range_misses"].inc()
            self._range_put(path, offset, length, data)
        return data

    def read_ranges(self, path: str,
                    ranges: List[Tuple[int, int]]) -> List[bytes]:
        """Vectored read: a whole-file hit slices every range; otherwise
        each range goes through `read_range`."""
        st = self.state
        if _cacheable(path):
            with st.lock:
                whole = st.cache.get(path)
                if whole is not None:
                    st.cache.move_to_end(path)
            if whole is not None:
                _counters()["file_hits"].inc()
                return [whole[o:o + n] for o, n in ranges]
        if not _cacheable(path) or st.range_capacity <= 0:
            return self.inner.read_ranges(path, ranges)
        return [self.read_range(path, o, n) for o, n in ranges]

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

    def mkdirs(self, path):
        return self.inner.mkdirs(path)

    def exists(self, path):
        return self.inner.exists(path)

    def get_file_size(self, path):
        return self.inner.get_file_size(path)

    def list_status(self, path):
        return self.inner.list_status(path)
