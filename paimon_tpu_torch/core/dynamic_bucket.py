"""Dynamic bucket mode: key-hash -> bucket index grown on demand.

Counterpart of paimon_tpu/core/dynamic_bucket.py with the assignment
vectorised over the batch.  Its buckets equal the reference's, hash for
hash, and its HASH index files equal the reference's byte for byte, so
each package reads the other's table.

reference: index/HashBucketAssigner.java + PartitionIndex.java (per
partition: a persistent set of key hashes per bucket, stored as raw
4-byte big-endian ints in HASH index files referenced from the index
manifest; new keys fill the active bucket until
dynamic-bucket.target-row-num, then a new bucket opens),
index/HashIndexFile.java (int file format).

The reference resolves unseen hashes one by one in Python and re-sorts
its whole base every 65,536 new hashes.  Here one batch costs one
`np.unique` of its hashes, two `searchsorted` passes of the sorted
distinct hashes (the base, then the hashes still pending) and one
sorted merge:

- an unseen hash takes its bucket at its first occurrence in the batch;
- the unseen hashes fill, in that order, the lowest-numbered bucket
  with room (the reference's `_bucket_with_capacity`, loaded buckets
  included), then new buckets opened after the highest one;
- two distinct keys whose 32-bit hashes collide share one entry, so
  bucket counts count hashes, not keys.

A bucket's index file lists the hashes merged into the sorted base in
ascending order, then the pending ones in assignment order, as the
reference's does: hashes stay pending until 65,536 of them have
accumulated at the end of a batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from paimon_tpu_torch.manifest import FileKind
from paimon_tpu_torch.manifest.index_manifest import (
    HASH_INDEX, IndexFileMeta, IndexManifestEntry,
)

__all__ = ["PartitionIndex", "DynamicBucketAssigner", "hash_index_entries",
           "load_partition_index", "lookup_sorted", "merge_sorted"]

# pending hashes merge into the sorted base once a batch leaves at least
# this many (the reference's `_compact_pending` threshold)
_PENDING_MERGE = 65536


def merge_sorted(base_k: np.ndarray, base_v: np.ndarray,
                 new_k: np.ndarray, new_v: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Insert keys `new_k` with values `new_v` into the sorted
    (base_k, base_v); new keys land after equal base keys, as a stable
    sort puts them."""
    if len(new_k) > 1 and not np.all(new_k[1:] >= new_k[:-1]):
        order = np.argsort(new_k, kind="stable")
        new_k, new_v = new_k[order], new_v[order]
    ins = np.searchsorted(base_k, new_k, side="right") + \
        np.arange(len(new_k))
    out_k = np.empty(len(base_k) + len(new_k), dtype=base_k.dtype)
    out_v = np.empty(len(out_k), dtype=base_v.dtype)
    rest = np.ones(len(out_k), dtype=bool)
    rest[ins] = False
    out_k[ins], out_v[ins] = new_k, new_v
    out_k[rest], out_v[rest] = base_k, base_v
    return out_k, out_v


def lookup_sorted(sorted_k: np.ndarray, sorted_v: np.ndarray,
                  k: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(found mask, value) of each key against sorted keys and their
    values (the value is meaningless where not found)."""
    if not len(sorted_k):
        return np.zeros(len(k), dtype=bool), \
            np.zeros(len(k), sorted_v.dtype)
    pos = np.minimum(np.searchsorted(sorted_k, k), len(sorted_k) - 1)
    return sorted_k[pos] == k, sorted_v[pos]


class PartitionIndex:
    """One partition's hash -> bucket mapping (reference
    index/PartitionIndex.java), resolved a batch at a time."""

    def __init__(self, target_row_num: int):
        self.target_row_num = target_row_num
        self._sorted_hashes = np.zeros(0, dtype=np.int64)
        self._sorted_buckets = np.zeros(0, dtype=np.int32)
        # assigned but not yet merged into the sorted base, in
        # assignment order
        self._pending_h = np.zeros(0, dtype=np.int64)
        self._pending_b = np.zeros(0, dtype=np.int32)
        self.bucket_counts: Dict[int, int] = {}
        self.dirty_buckets: set = set()

    def load_buckets(self, loaded: List[Tuple[int, np.ndarray]]) -> None:
        """Load persisted buckets, in index-manifest order: one stable
        sort for all of them (equal hashes keep load order, as the
        reference's one sort per bucket leaves them)."""
        if not loaded:
            return
        h = np.concatenate([self._sorted_hashes] + [
            np.asarray(x, dtype=np.int64) for _, x in loaded])
        b = np.concatenate([self._sorted_buckets] + [
            np.full(len(x), bucket, np.int32) for bucket, x in loaded])
        order = np.argsort(h, kind="stable")
        self._sorted_hashes, self._sorted_buckets = h[order], b[order]
        for bucket, x in loaded:
            self.bucket_counts[bucket] = \
                self.bucket_counts.get(bucket, 0) + len(x)

    def load_bucket(self, bucket: int, hashes: np.ndarray) -> None:
        self.load_buckets([(bucket, hashes)])

    def lookup(self, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(found, bucket) of each hash, assigning nothing."""
        found, out = lookup_sorted(self._sorted_hashes,
                                   self._sorted_buckets, h)
        rest = np.flatnonzero(~found)
        if len(rest) and len(self._pending_h):
            order = np.argsort(self._pending_h, kind="stable")
            hit, b = lookup_sorted(self._pending_h[order],
                             self._pending_b[order], h[rest])
            out[rest[hit]] = b[hit]
            found[rest[hit]] = True
        return found, out

    def assign(self, hashes: np.ndarray) -> np.ndarray:
        """hashes -> buckets; unseen hashes go to the first bucket with
        capacity (new buckets open as needed)."""
        h = np.asarray(hashes, dtype=np.int64)
        if not len(h):
            return np.empty(0, dtype=np.int32)
        # the lookups run on the batch's sorted distinct hashes: sorted
        # needles keep searchsorted's walk through the base cache-local
        uniq, first, inverse = np.unique(h, return_index=True,
                                         return_inverse=True)
        inverse = inverse.reshape(-1)
        found, buckets = self.lookup(uniq)
        sorted_new = None
        if not found.all():
            # the unseen distinct hashes in the order they arrive
            arrived = np.zeros(len(h), dtype=bool)
            arrived[first[~found]] = True
            by_arrival = inverse[np.flatnonzero(arrived)]
            buckets[by_arrival] = self._fill(len(by_arrival))
            if not len(self._pending_h):
                sorted_new = (uniq[~found], buckets[~found])
            self._pending_h = np.concatenate(
                [self._pending_h, uniq[by_arrival]])
            self._pending_b = np.concatenate(
                [self._pending_b, buckets[by_arrival]])
        if len(self._pending_h) >= _PENDING_MERGE:
            self._sorted_hashes, self._sorted_buckets = merge_sorted(
                self._sorted_hashes, self._sorted_buckets,
                *(sorted_new or (self._pending_h, self._pending_b)))
            self._pending_h = np.zeros(0, dtype=np.int64)
            self._pending_b = np.zeros(0, dtype=np.int32)
        return buckets[inverse]

    def _fill(self, n: int) -> np.ndarray:
        """Buckets of `n` unseen hashes in arrival order: the room of
        every existing bucket in bucket order, then new buckets after
        the highest (a full bucket stays full, so this is the
        reference's lowest-bucket-with-capacity rule applied n times)."""
        out = np.empty(n, dtype=np.int32)
        done = 0
        for b in sorted(self.bucket_counts):
            room = self.target_row_num - self.bucket_counts[b]
            if room <= 0:
                continue
            take = min(room, n - done)
            out[done:done + take] = b
            self.bucket_counts[b] += take
            self.dirty_buckets.add(b)
            done += take
            if done == n:
                return out
        nxt = max(self.bucket_counts, default=-1) + 1
        # a bucket holds at least the hash that opened it
        per = max(self.target_row_num, 1)
        while done < n:
            take = min(per, n - done)
            out[done:done + take] = nxt
            self.bucket_counts[nxt] = take
            self.dirty_buckets.add(nxt)
            done += take
            nxt += 1
        return out

    def bucket_hashes(self, bucket: int) -> np.ndarray:
        """The bucket's hashes as its index file lists them."""
        return np.concatenate([
            self._sorted_hashes[self._sorted_buckets == bucket],
            self._pending_h[self._pending_b == bucket]])


def hash_index_entries(scan, snapshot) -> List[IndexManifestEntry]:
    """The HASH entries of `snapshot`'s index manifest."""
    if snapshot is None or not snapshot.index_manifest:
        return []
    return [e for e in scan.index_manifest_file.read(snapshot.index_manifest)
            if e.index_file.index_type == HASH_INDEX]


def load_partition_index(scan, entries: List[IndexManifestEntry],
                         partition: Tuple,
                         target_row_num: int) -> PartitionIndex:
    """One partition's index from its HASH index files."""
    idx = PartitionIndex(target_row_num)
    pbytes = scan._partition_codec.to_bytes(partition)
    loaded = []
    for e in entries:
        if e.partition != pbytes:
            continue
        data = scan.file_io.read_bytes(
            scan.path_factory.index_file_path(e.index_file.file_name))
        loaded.append((e.bucket, np.frombuffer(data, dtype=">i4")))
    idx.load_buckets(loaded)
    return idx


class DynamicBucketAssigner:
    """Loads per-partition hash indexes from the latest snapshot, assigns
    buckets for new rows, and produces the replacement index-manifest
    entries at prepare-commit."""

    def __init__(self, scan, target_row_num: int):
        self.scan = scan
        self.target_row_num = target_row_num
        self._indexes: Dict[Tuple, PartitionIndex] = {}
        self._prev_entries: Optional[List[IndexManifestEntry]] = None

    # -- persistent index ----------------------------------------------------

    def _load_prev_entries(self) -> List[IndexManifestEntry]:
        if self._prev_entries is None:
            self._prev_entries = hash_index_entries(
                self.scan, self.scan.snapshot_manager.latest_snapshot())
        return self._prev_entries

    def _index(self, partition: Tuple) -> PartitionIndex:
        idx = self._indexes.get(partition)
        if idx is None:
            idx = self._indexes[partition] = load_partition_index(
                self.scan, self._load_prev_entries(), partition,
                self.target_row_num)
        return idx

    # -- assignment ----------------------------------------------------------

    def assign(self, partition: Tuple, hashes: np.ndarray) -> np.ndarray:
        return self._index(partition).assign(
            np.asarray(as_int32(hashes), dtype=np.int64))

    # -- commit --------------------------------------------------------------

    def index_entries(self) -> List[IndexManifestEntry]:
        """Replacement HASH index entries for every dirty bucket (old
        entry deleted, full rewritten file added — reference
        DynamicBucketIndexMaintainer.prepareCommit)."""
        # re-read the live entry list: a previous prepare_commit from this
        # writer may have committed entries the DELETE list must cover
        self._prev_entries = None
        entries: List[IndexManifestEntry] = []
        for partition, idx in self._indexes.items():
            if not idx.dirty_buckets:
                continue
            pbytes = self.scan._partition_codec.to_bytes(partition)
            for e in self._load_prev_entries():
                if e.partition == pbytes and e.bucket in idx.dirty_buckets:
                    entries.append(IndexManifestEntry(
                        FileKind.DELETE, e.partition, e.bucket,
                        e.index_file))
            for b in sorted(idx.dirty_buckets):
                hashes = idx.bucket_hashes(b).astype(">i4")
                name = self.scan.path_factory.new_index_file_name()
                path = self.scan.path_factory.index_file_path(name)
                self.scan.file_io.write_bytes(path, hashes.tobytes(),
                                              overwrite=False)
                entries.append(IndexManifestEntry(
                    FileKind.ADD, pbytes, b,
                    IndexFileMeta(HASH_INDEX, name, hashes.nbytes,
                                  len(hashes))))
            idx.dirty_buckets = set()
        return entries


def as_int32(hashes: np.ndarray) -> np.ndarray:
    """The murmur hashes' low 32 bits as signed ints (the index files'
    values)."""
    if hashes.dtype == np.int32:
        return hashes
    return hashes.astype(np.uint64).astype(np.uint32).view(np.int32)
