"""Local sorted-run (SST) lookup files with bloom filters and bounded
caches.

Counterpart of paimon_tpu/lookup/sst.py; the file format (PTSST1) is
the reference's byte for byte, so an SST written by either package is
probed by the other, and warm boot's `LookupStore.adopt` registers one
persisted by either package.

reference: paimon-common/.../sst/SstFileReader.java and paimon-core
.../lookup/sort/SortLookupStoreFactory.java:39,65: lookup files spill
into local sorted block files with bloom filters, a probe touches one
block, and the disk they take is bounded with LRU file eviction
(mergetree/LookupLevels.java:308).

Keys are the normalized-key lanes (uint32[L], ops/normkey.py) packed
big-endian per row into fixed-width byte strings, so bytes compare as
the keys do.  File layout:
    "PTSST1"
    block 0: zstd Arrow IPC (lane columns + row columns), key-sorted
    block 1: ...
    keys section: zstd of the packed keys, one flat sorted
        uint8[num_rows * key_width] buffer (the native probe's search
        array)
    footer (zstd JSON): per-block {offset, size, rows, first_key(b64)},
        bloom filter (b64) over splitmix64 of the packed keys, num_rows,
        keys {offset, size, raw}
    u32 footer_len, "PTSST1"

A probe batch takes the native path by default (native/probe.c
`sst_probe_batch`: bloom and binary search over the flat key buffer,
one C call per batch with the GIL released); where the library or its
symbol is unavailable the call takes the numpy walk and counts
`lookup.native_fallbacks`.  This is host work on both packages' paths:
a point get touches a few bytes of one block.

The in-RAM block cache is bounded by bytes
(lookup.cache-max-memory-size), the on-disk store per table by
lookup.cache-max-disk-size.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import struct
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.index.bloom import BloomFilter, _splitmix64

__all__ = ["SstWriter", "SstReader", "BlockCache", "LookupStore",
           "pack_lanes", "force_python_probe"]

_MAGIC = b"PTSST1"
DEFAULT_BLOCK_ROWS = 4096


def pack_lanes(lanes: np.ndarray) -> np.ndarray:
    """uint32[N, L] -> |S(4L)| fixed-width byte keys whose bytewise
    order equals the lanes' lexicographic order."""
    n, num_lanes = lanes.shape
    be = lanes.astype(">u4")
    return np.frombuffer(be.tobytes(), dtype=f"S{4 * num_lanes}",
                         count=n)


def _key_hashes(packed: np.ndarray) -> np.ndarray:
    """uint64 hash per packed key (first 8 bytes + length mix; packed
    keys are fixed width so a cheap vectorized fold suffices)."""
    width = packed.dtype.itemsize
    raw = np.frombuffer(packed.tobytes(), dtype=np.uint8) \
        .reshape(len(packed), width)
    acc = np.zeros(len(packed), dtype=np.uint64)
    for i in range(0, width, 8):
        chunk = raw[:, i:i + 8]
        if chunk.shape[1] < 8:
            pad = np.zeros((len(packed), 8 - chunk.shape[1]), np.uint8)
            chunk = np.concatenate([chunk, pad], axis=1)
        acc ^= _splitmix64(chunk.copy().view(np.uint64).reshape(-1))
    return _splitmix64(acc)


class SstWriter:
    def __init__(self, block_rows: int = DEFAULT_BLOCK_ROWS,
                 bloom_fpp: float = 0.01, compression: str = "zstd"):
        self.block_rows = block_rows
        self.bloom_fpp = bloom_fpp
        self.compression = compression

    def write(self, path: str, lanes: np.ndarray,
              table: pa.Table) -> int:
        """`table` rows sorted by `lanes`; returns file size."""
        n = table.num_rows
        assert lanes.shape[0] == n
        packed = pack_lanes(lanes)
        num_lanes = lanes.shape[1]
        lane_cols = {f"__lane{i}": pa.array(lanes[:, i], pa.uint32())
                     for i in range(num_lanes)}
        full = table
        for name, col in lane_cols.items():
            full = full.append_column(name, col)

        out = io.BytesIO()
        out.write(_MAGIC)
        blocks = []
        try:
            opts = pa.ipc.IpcWriteOptions(compression=self.compression)
        except (pa.ArrowInvalid, TypeError):
            opts = pa.ipc.IpcWriteOptions()
        for start in range(0, max(n, 1), self.block_rows):
            chunk = full.slice(start, min(self.block_rows, n - start)) \
                if n else full
            sink = io.BytesIO()
            with pa.ipc.new_stream(sink, full.schema, options=opts) as w:
                w.write_table(chunk)
            blob = sink.getvalue()
            blocks.append({
                "offset": out.tell(), "size": len(blob),
                "rows": chunk.num_rows,
                "first_key": base64.b64encode(
                    packed[start].tobytes() if n else b"").decode(),
            })
            out.write(blob)
            if n == 0:
                break
        bloom = BloomFilter.build(_key_hashes(packed), self.bloom_fpp) \
            if n else None
        # flat sorted key buffer: the native probe's contiguous search
        # array, written once here so probes never re-pack block lanes
        raw_keys = packed.tobytes()
        keys_off = out.tell()
        comp_keys = pa.Codec("zstd").compress(raw_keys)
        if isinstance(comp_keys, pa.Buffer):
            comp_keys = comp_keys.to_pybytes()
        out.write(comp_keys)
        footer = {
            "num_rows": n, "num_lanes": num_lanes,
            "key_width": 4 * num_lanes,
            "blocks": blocks,
            "keys": {"offset": keys_off, "size": len(comp_keys),
                     "raw": len(raw_keys)},
            "bloom": base64.b64encode(bloom.serialize()).decode()
            if bloom else None,
        }
        fb = json.dumps(footer).encode()
        comp = pa.Codec("zstd").compress(fb)
        comp = comp.to_pybytes() if isinstance(comp, pa.Buffer) else comp
        tail = struct.pack("<I", len(fb)) + comp
        out.write(tail)
        out.write(struct.pack("<I", len(tail)))
        out.write(_MAGIC)
        data = out.getvalue()
        with open(path, "wb") as f:
            f.write(data)
        return len(data)


_COUNTERS = None


def _block_counters():
    """Lookup-group block-cache Counters resolved once per process
    (same pattern as fs/caching.py — registry lookups take locks,
    too heavy per block read)."""
    global _COUNTERS
    if _COUNTERS is None:
        from paimon_tpu_torch import metrics as m
        group = m.global_registry().lookup_metrics()
        _COUNTERS = {
            "hits": group.counter(m.LOOKUP_BLOCK_CACHE_HITS),
            "misses": group.counter(m.LOOKUP_BLOCK_CACHE_MISSES),
            "native": group.counter(m.LOOKUP_NATIVE_PROBES),
            "fallbacks": group.counter(m.LOOKUP_NATIVE_FALLBACKS),
        }
    return _COUNTERS


# bench/test override: force the numpy probe even when the native
# library is loaded (the native-vs-python comparisons need both paths
# over the SAME readers)
_FORCE_PYTHON_PROBE = False

# paimon_tpu_torch.native, resolved once on first probe (a sys.modules
# lookup per probe is measurable at serving batch sizes)
_native_mod = None


@contextlib.contextmanager
def force_python_probe():
    global _FORCE_PYTHON_PROBE
    prev = _FORCE_PYTHON_PROBE
    _FORCE_PYTHON_PROBE = True
    try:
        yield
    finally:
        _FORCE_PYTHON_PROBE = prev


class BlockCache:
    """Global byte-bounded LRU over decoded blocks (role of reference
    io/cache/CacheManager for lookup pages) — the PINNED tier of the
    point-lookup path: per-reader index state (block first-keys, bloom
    filter) lives unevictably on the reader itself, only data blocks
    rotate through this cache.  Thread-safe: the serving plane probes
    it from every handler thread."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._lru: "OrderedDict[Tuple, pa.Table]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key: Tuple) -> Optional[pa.Table]:
        with self._lock:
            t = self._lru.get(key)
            if t is not None:
                self._lru.move_to_end(key)
        c = _block_counters()
        (c["hits"] if t is not None else c["misses"]).inc()
        return t

    def put(self, key: Tuple, t: pa.Table):
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                return
            self._lru[key] = t
            self._bytes += t.nbytes
            while self._bytes > self.max_bytes and len(self._lru) > 1:
                _, old = self._lru.popitem(last=False)
                self._bytes -= old.nbytes

    def drop_file(self, path: str):
        with self._lock:
            for k in [k for k in self._lru if k[0] == path]:
                self._bytes -= self._lru.pop(k).nbytes


_GLOBAL_BLOCK_CACHE = BlockCache()


class SstReader:
    def __init__(self, path: str,
                 block_cache: Optional[BlockCache] = None,
                 native_probe: bool = True):
        self.path = path
        self.cache = block_cache or _GLOBAL_BLOCK_CACHE
        self.native_probe = native_probe
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(size - 10)
            tail_len, magic = struct.unpack("<I6s", f.read(10))
            if magic != _MAGIC:
                raise ValueError(f"not an SST file: {path}")
            f.seek(size - 10 - tail_len)
            tail = f.read(tail_len)
        (raw_len,) = struct.unpack_from("<I", tail, 0)
        fb = pa.Codec("zstd").decompress(tail[4:],
                                         decompressed_size=raw_len)
        if isinstance(fb, pa.Buffer):
            fb = fb.to_pybytes()
        self.footer = json.loads(fb)
        self._file_size = size
        self.num_rows = self.footer["num_rows"]
        kw = self.footer["key_width"]
        self._first_keys = np.array(
            [base64.b64decode(b["first_key"]) for b in
             self.footer["blocks"]], dtype=f"S{kw}") \
            if self.footer["blocks"] else np.zeros(0, dtype=f"S{kw}")
        self._bloom = BloomFilter.deserialize(
            base64.b64decode(self.footer["bloom"])) \
            if self.footer.get("bloom") else None
        # global row index -> block: starts[i] is block i's first row
        rows = [b["rows"] for b in self.footer["blocks"]]
        self._row_starts = np.concatenate(
            [np.zeros(1, np.int64),
             np.cumsum(rows, dtype=np.int64)]) \
            if rows else np.zeros(1, np.int64)
        self._lane_cols = [f"__lane{i}" for i in
                           range(self.footer["num_lanes"])]
        # raw-pointer native probe context (native.sst_probe_prepare),
        # resolved lazily once; False = native probe unavailable
        self._native_prep = None
        # flat sorted key buffer (PINNED once loaded, like the bloom
        # and first-keys index): lazy — the python path never needs it
        self._flat: Optional[np.ndarray] = None
        self._flat_lock = threading.Lock()

    @property
    def file_size(self) -> int:
        return self._file_size

    def _flat_keys(self) -> np.ndarray:
        """The contiguous uint8[num_rows * key_width] sorted key buffer
        the native probe searches, read once from the keys section
        (every SST this store holds was written in this process)."""
        f = self._flat
        if f is not None:
            return f
        with self._flat_lock:
            if self._flat is None:
                ks = self.footer["keys"]
                buf = b""
                if ks["raw"]:
                    with open(self.path, "rb") as fh:
                        fh.seek(ks["offset"])
                        blob = fh.read(ks["size"])
                    buf = pa.Codec("zstd").decompress(
                        blob, decompressed_size=ks["raw"])
                    if isinstance(buf, pa.Buffer):
                        buf = buf.to_pybytes()
                self._flat = np.frombuffer(buf, dtype=np.uint8)
        return self._flat

    def _block(self, i: int) -> pa.Table:
        key = (self.path, i)
        t = self.cache.get(key)
        if t is None:
            b = self.footer["blocks"][i]
            with open(self.path, "rb") as f:
                f.seek(b["offset"])
                blob = f.read(b["size"])
            with pa.ipc.open_stream(pa.BufferReader(blob)) as r:
                t = r.read_all()
            self.cache.put(key, t)
        return t

    def probe(self, lanes: Optional[np.ndarray],
              packed: Optional[np.ndarray] = None,
              hashes: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, pa.Table]:
        """Batch probe: query lanes uint32[M, L] ->
        (hit_query_positions int64[H], matched rows pa.Table[H] minus
        lane columns, aligned with the positions).

        `packed`/`hashes` let the caller pack and hash the query ONCE
        per lookup batch and slice per (bucket, run) — at batch sizes
        of a few keys the per-probe pack/hash ceremony would rival
        the probe itself.

        Native by default: one `sst_probe_batch` C call resolves the
        whole batch (bloom + flat-key binary search, GIL released);
        only the few hit rows are then gathered from cached blocks.
        Unavailable native (no compiler, PAIMON_DISABLE_NATIVE, or a
        stale `.so` without the probe symbol) degrades this call to
        the numpy path and counts a `lookup.native_fallbacks`.

        When `packed` is supplied, `lanes` may be None — both probe
        flavors work off the packed big-endian keys alone."""
        if packed is None:
            packed = pack_lanes(lanes)
        m = packed.shape[0]
        if m == 0 or self.num_rows == 0:
            return np.zeros(0, np.int64), None
        if self.native_probe and not _FORCE_PYTHON_PROBE:
            res = self._probe_native(packed, hashes)
            if res is not None:
                _block_counters()["native"].inc()
                return res
            _block_counters()["fallbacks"].inc()
        return self._probe_python(packed, hashes)

    def _probe_native(self, packed: np.ndarray,
                      hashes: Optional[np.ndarray] = None
                      ) -> Optional[Tuple[np.ndarray, pa.Table]]:
        global _native_mod
        native = _native_mod
        if native is None:
            from paimon_tpu_torch import native as _nm
            native = _native_mod = _nm
        kw = packed.dtype.itemsize
        if hashes is None:
            hashes = _key_hashes(packed)
        if packed.flags.c_contiguous:
            qkeys = packed.view(np.uint8)    # zero-copy byte view
        else:
            qkeys = np.frombuffer(packed.tobytes(), dtype=np.uint8)
        prep = self._native_prep
        if prep is None:
            prep = native.sst_probe_prepare(
                self._flat_keys(), self.num_rows, kw,
                self._bloom.bits if self._bloom is not None else None,
                self._bloom.k if self._bloom is not None else 0)
            self._native_prep = prep if prep is not None else False
        if prep:
            res = native.sst_probe_prepared(prep, qkeys, hashes)
        else:
            res = native.sst_probe(
                self._flat_keys(), self.num_rows, kw,
                self._bloom.bits if self._bloom is not None else None,
                self._bloom.k if self._bloom is not None else 0,
                qkeys, hashes)
        if res is None:
            return None
        lo, hi = res
        hit_q = (hi > lo).nonzero()[0]
        if len(hit_q) == 0:
            return np.zeros(0, np.int64), None
        starts = self._row_starts
        if len(hit_q) <= 2:
            # scalar gather for the 1-2 hit case — the serving norm
            # is ONE key per (bucket, run) probe, where the vectorized
            # argsort/unique ceremony below costs more than the C
            # probe itself
            parts = []
            for qi in hit_q:
                s, e = int(lo[qi]), int(hi[qi])
                b = int(np.searchsorted(starts, s, side="right")) - 1
                if e - s != 1 or e > int(starts[b + 1]):
                    parts = None
                    break          # equal-key run / block spanner
                parts.append(
                    self._block(b).slice(s - int(starts[b]), 1))
            if parts is not None:
                out = parts[0] if len(parts) == 1 else \
                    pa.concat_tables(parts, promote_options="none")
                return (hit_q.astype(np.int64),
                        out.drop_columns(self._lane_cols))
        lo_h = lo[hit_q]
        hi_h = hi[hit_q]
        # block of each hit's first and last row, vectorized: the
        # common case (single-row hit inside one block) gathers with
        # ONE `take` per touched block — per-hit python slicing here
        # would cost more than the whole C probe
        b_lo = np.searchsorted(starts, lo_h, side="right") - 1
        b_last = np.searchsorted(starts, hi_h - 1, side="right") - 1
        fast = (hi_h - lo_h == 1) & (b_lo == b_last)
        hits_parts: List[np.ndarray] = []
        rows: List[pa.Table] = []
        if fast.any():
            qf, rf, bf = hit_q[fast], lo_h[fast], b_lo[fast]
            order = np.argsort(bf, kind="stable")
            qf, rf, bf = qf[order], rf[order], bf[order]
            blocks, cuts = np.unique(bf, return_index=True)
            for g, b in enumerate(blocks):
                s = cuts[g]
                e = cuts[g + 1] if g + 1 < len(blocks) else len(bf)
                t = self._block(int(b))
                if e - s <= 4:
                    # zero-copy slices beat a gather kernel for a
                    # handful of rows (the serving batch case)
                    for r in rf[s:e] - int(starts[b]):
                        rows.append(t.slice(int(r), 1))
                else:
                    rows.append(t.take(rf[s:e] - int(starts[b])))
                hits_parts.append(qf[s:e])
        for qi in hit_q[~fast]:    # equal-key runs / block-spanners
            s, e = int(lo[qi]), int(hi[qi])
            b = int(np.searchsorted(starts, s, side="right")) - 1
            while s < e:
                take = min(e, int(starts[b + 1])) - s
                t = self._block(b)
                rows.append(t.slice(s - int(starts[b]), take))
                hits_parts.append(np.full(take, qi, np.int64))
                s += take
                b += 1
        out = pa.concat_tables(rows, promote_options="none")
        drop = self._lane_cols
        return (np.concatenate(hits_parts).astype(np.int64),
                out.drop_columns(drop))

    def _probe_python(self, packed: np.ndarray,
                      hashes: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, pa.Table]:
        m = len(packed)
        cand = np.arange(m)
        if self._bloom is not None:
            keep = self._bloom.might_contain_many(
                _key_hashes(packed) if hashes is None else hashes)
            cand = cand[keep]
            if len(cand) == 0:
                return np.zeros(0, np.int64), None
        q = packed[cand]
        # block of each candidate: RIGHTMOST block whose first key <= q.
        # A run of equal packed keys (possible: lanes are prefix-
        # truncated for long strings) always ENDS in that block, but may
        # start in earlier blocks — extended backward below.
        blk = np.searchsorted(self._first_keys, q, side="right") - 1
        blk = np.maximum(blk, 0)
        hits: List[int] = []
        rows: List[pa.Table] = []

        def block_keys(b: int):
            t = self._block(b)
            nl = self.footer["num_lanes"]
            lanes_mat = np.stack(
                [np.asarray(t.column(f"__lane{i}")) for i in range(nl)],
                axis=1).astype(np.uint32)
            return t, pack_lanes(lanes_mat)

        for b in np.unique(blk):
            sel = blk == b
            t, bk = block_keys(int(b))
            lo = np.searchsorted(bk, q[sel], side="left")
            hi = np.searchsorted(bk, q[sel], side="right")
            for qi, key, s, e in zip(cand[sel], q[sel], lo, hi):
                if s == e:
                    continue
                hits.extend([int(qi)] * (e - s))
                rows.append(t.slice(s, e - s))
                pb = int(b)
                while s == 0 and pb > 0:
                    pb -= 1
                    tp, bkp = block_keys(pb)
                    s2 = int(np.searchsorted(bkp, key, side="left"))
                    e2 = int(np.searchsorted(bkp, key, side="right"))
                    if s2 == e2:
                        break
                    hits.extend([int(qi)] * (e2 - s2))
                    rows.append(tp.slice(s2, e2 - s2))
                    s = s2
        if not hits:
            return np.zeros(0, np.int64), None
        out = pa.concat_tables(rows, promote_options="none")
        drop = self._lane_cols
        return (np.array(hits, dtype=np.int64), out.drop_columns(drop))


class LookupStore:
    """Size-bounded local store of SST files, keyed by (partition,
    bucket, snapshot): files evict least-recently-used when the disk
    budget is exceeded (reference SortLookupStoreFactory + LookupLevels
    file eviction at mergetree/LookupLevels.java:308).

    Thread-safe: the serving plane's lookup batches build and probe
    concurrently (LocalTableQuery only serializes plan swaps, not
    reads), so the reader map and disk accounting are internally
    locked.  The SST file write in put() happens OUTSIDE the lock —
    it is the expensive part and writes a not-yet-published path."""

    def __init__(self, directory: str,
                 max_disk_bytes: int = 10 << 30,
                 block_cache: Optional[BlockCache] = None,
                 native_probe: bool = True):
        self.dir = directory
        self.max_disk = max_disk_bytes
        self.block_cache = block_cache or _GLOBAL_BLOCK_CACHE
        self.native_probe = native_probe
        os.makedirs(directory, exist_ok=True)
        # the store is a CACHE: files from a previous process can never
        # be trusted (snapshot may have moved) and would escape the
        # disk budget — start clean
        for name in os.listdir(directory):
            if name.endswith(".sst"):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass
        self._readers: "OrderedDict[str, SstReader]" = OrderedDict()
        self._disk_bytes = 0              # running total: no per-put stats
        self._lock = threading.Lock()
        self._closed = False

    def _evict_to_budget_locked(self):
        while self._disk_bytes > self.max_disk and len(self._readers) > 1:
            name, reader = self._readers.popitem(last=False)
            self._disk_bytes -= reader.file_size
            self.block_cache.drop_file(reader.path)
            try:
                os.remove(reader.path)
            # lint-ok: fault-taxonomy eviction sweep, not a retry:
            # popitem guarantees progress and a vanished spill file is
            # the eviction's desired end state
            except OSError:
                pass

    def get(self, key: str) -> Optional[SstReader]:
        with self._lock:
            r = self._readers.get(key)
            if r is not None:
                self._readers.move_to_end(key)
            return r

    def put(self, key: str, lanes: np.ndarray, table: pa.Table,
            writer: Optional[SstWriter] = None) -> SstReader:
        import hashlib
        import uuid
        # hash the key into the file name: composite keys (partition
        # values etc.) must never collide after path sanitization.  A
        # short random suffix keeps concurrent same-key builders from
        # writing one path (last publisher wins; the loser's file is
        # removed below)
        digest = hashlib.sha1(key.encode("utf-8")).hexdigest()[:24]
        path = os.path.join(self.dir,
                            f"{digest}-{uuid.uuid4().hex[:8]}.sst")
        (writer or SstWriter()).write(path, lanes, table)
        reader = SstReader(path, self.block_cache,
                           native_probe=self.native_probe)
        return self._publish(key, reader)

    def adopt(self, key: str, src_path: str) -> SstReader:
        """Register an already-built SST file under `key` (warm boot's
        restore: another process persisted the file through the shared
        SSD tier).  The file is hard-linked, or copied across file
        systems, into the store directory under the usual naming, so
        eviction and the disk budget treat it as a locally built SST.
        No reader build is counted: that is the point of warm boot."""
        import hashlib
        import shutil
        import uuid
        digest = hashlib.sha1(key.encode("utf-8")).hexdigest()[:24]
        path = os.path.join(self.dir,
                            f"{digest}-{uuid.uuid4().hex[:8]}.sst")
        try:
            os.link(src_path, path)
        except OSError:
            shutil.copyfile(src_path, path)
        reader = SstReader(path, self.block_cache,
                           native_probe=self.native_probe)
        return self._publish(key, reader)

    def _publish(self, key: str, reader: SstReader) -> SstReader:
        path = reader.path
        with self._lock:
            if self._closed:
                # a build racing close(): publishing would leak a
                # file the owner just promised to have cleaned up
                try:
                    os.remove(path)
                except OSError:
                    pass
                raise RuntimeError("lookup store is closed")
            old = self._readers.pop(key, None)
            if old is not None:
                self.block_cache.drop_file(old.path)
                self._disk_bytes -= old.file_size
                try:
                    os.remove(old.path)
                except OSError:
                    pass
            self._readers[key] = reader
            self._disk_bytes += reader.file_size
            self._evict_to_budget_locked()
            return self._readers.get(key)

    def drop(self, key: str):
        """Drop one entry (reader + SST file + its cached blocks) —
        the serving plane's eviction for files dropped by compaction
        and buckets dropped by snapshot advance."""
        with self._lock:
            r = self._readers.pop(key, None)
            if r is None:
                return
            self.block_cache.drop_file(r.path)
            self._disk_bytes -= r.file_size
        try:
            os.remove(r.path)
        except OSError:
            pass

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._readers)

    def drop_all(self, close: bool = False):
        """Drop every entry; `close=True` additionally marks the store
        closed so concurrent in-flight builds cannot republish files
        afterwards (their put() removes its own file and raises)."""
        with self._lock:
            readers = list(self._readers.items())
            self._readers.clear()
            self._disk_bytes = 0
            if close:
                self._closed = True
        for _, r in readers:
            self.block_cache.drop_file(r.path)
            try:
                os.remove(r.path)
            except OSError:
                pass
