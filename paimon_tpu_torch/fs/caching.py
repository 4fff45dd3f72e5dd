"""The process-wide format-footer cache.

Counterpart of the footer-cache part of paimon_tpu/fs/caching.py (its
block cache, host-SSD tier and hedged reads are not ported yet).
reference: FileReaderFactory's ParquetFileReader footer reuse.  Only
files whose names mark them immutable (uuid'd data/manifest/index
files, schema-N) are cached.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from contextlib import contextmanager, nullcontext

__all__ = ["FooterCache", "global_footer_cache", "footer_cache_disabled",
           "footer_cache_scope", "scoped_batches"]

# snapshot-N files are deliberately NOT cached: rollback_to /
# fast_forward delete and later recreate the same snapshot ids with
# different content; schema-N ids are append-only
_IMMUTABLE = re.compile(
    r"^(data-|changelog-|manifest-|index-|stats-|schema-\d+$)")


def _cacheable(path: str) -> bool:
    return bool(_IMMUTABLE.match(path.rsplit("/", 1)[-1]))


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
