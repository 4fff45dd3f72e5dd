"""Cross-partition upsert: primary keys that do NOT contain the
partition keys.

Counterpart of paimon_tpu/core/cross_partition.py.  reference:
crosspartition/GlobalIndexAssigner.java (RocksDB-backed key ->
(partition, bucket); on partition change routes a -D to the old
partition then the +I to the new one), IndexBootstrap.java (bootstrap
the index from the table), KEY_DYNAMIC bucket mode.

The global index is two-tier, as in the reference: a persistent sorted
base bootstrapped once per snapshot by one projected scan (pk and
partition columns) and spilled as an SST next to the table
(lookup/sst.py, shared by writers at the same snapshot), plus this
writer's own changes on top (an overlay, None = deleted).

A key whose normalized lanes are exact (integer key columns) takes the
vectorised path: the overlay is a sorted array of packed keys with a
partition code each, and a batch is resolved with sorts and
searchsorted over its rows grouped by key.  Other keys (strings, whose
lanes may be a truncated prefix) take the reference's row loop over key
tuples.  Both give one row per key: within a batch and across writers,
a key that moves partition writes -D to the old partition (before the
batch's rows), then +I to the new one, and an insert that a later row
of the same batch moves to another partition never materializes.  The
reference drops only the insert just before such a move, so a key
upserted twice in one partition and then moved keeps a stale row there
(ROADMAP.md C); this package drops every such insert.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.core.dynamic_bucket import lookup_sorted, merge_sorted
from paimon_tpu_torch.core.write import extract_row_kinds, unique_rows
from paimon_tpu_torch.fs import LocalFileIO
from paimon_tpu_torch.lookup.sst import (
    _GLOBAL_BLOCK_CACHE, SstReader, SstWriter, pack_lanes,
)
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.types import RowKind, data_type_to_arrow

__all__ = ["CrossPartitionUpsertWrite"]

_RETRACT_KINDS = (RowKind.DELETE, RowKind.UPDATE_BEFORE)
_NONE = -1          # partition code of "no live row"


def _sortable(packed: np.ndarray) -> np.ndarray:
    """Packed big-endian keys as an array numpy sorts in key order
    (one u64 for the one-BIGINT key)."""
    if packed.dtype.itemsize == 8:
        return packed.view(">u8").astype(np.uint64)
    return packed


class CrossPartitionUpsertWrite:
    """Wraps the (dynamic-bucket) KeyValueFileStoreWrite: incoming rows
    whose key already lives in another partition first retract the old
    row (reference ExistingProcessor#DELETE semantics)."""

    def __init__(self, inner, table):
        self.inner = inner
        self.table = table
        self.pk = table.schema.trimmed_primary_keys()
        self.partition_keys = table.schema.partition_keys
        rt = table.schema.logical_row_type()
        self._encoder = NormalizedKeyEncoder(
            [data_type_to_arrow(rt.get_field(k).type) for k in self.pk],
            nullable=[rt.get_field(k).type.nullable for k in self.pk])
        self._exact = all(k == "int" for k in self._encoder._kinds)
        # partitions by code (vectorised path)
        self._parts: List[Tuple] = []
        self._part_code: Dict[Tuple, int] = {}
        # this writer's changes: sorted keys -> partition code (vectorised
        # path) or key tuple -> partition tuple (row path)
        self._ov_keys = np.zeros(0, dtype=np.uint64)
        self._ov_codes = np.zeros(0, dtype=np.int32)
        self._overlay: Dict[Tuple, Optional[Tuple]] = {}
        # the base: an SST reader, or in RAM where the FileIO is not local
        self._reader: Optional[SstReader] = None
        self._ram_base = None
        self._bootstrapped = False
        self.bootstrap_seconds = 0.0

    # -- bootstrap (reference IndexBootstrap) --------------------------------

    def _index_dir(self) -> str:
        return f"{self.table.path}/index/cross-partition"

    def _bootstrap_store(self):
        """Build or load the persistent base index for the latest
        snapshot.  A FileIO that is not local keeps the base in RAM."""
        if self._bootstrapped:
            return
        self._bootstrapped = True
        snapshot = self.table.snapshot_manager.latest_snapshot()
        if snapshot is None:
            return
        t0 = time.perf_counter()
        try:
            self._load_base(snapshot)
        finally:
            self.bootstrap_seconds += time.perf_counter() - t0

    def _scan_base(self) -> Tuple[pa.Table, np.ndarray]:
        """The table's live (pk, partition) rows sorted by key, with
        their lanes."""
        cols = list(dict.fromkeys(self.pk + self.partition_keys))
        data = self.table.to_arrow(projection=cols).select(cols)
        lanes, _ = self._encoder.encode_table(data, self.pk)
        lanes = np.asarray(lanes)
        packed = pack_lanes(lanes)
        order = np.argsort(_sortable(packed) if self._exact else packed,
                           kind="stable")
        return data.take(pa.array(order)), lanes[order]

    def _load_base(self, snapshot) -> None:
        if not isinstance(self.table.file_io, LocalFileIO):
            data, lanes = self._scan_base()
            if self._exact:
                self._ram_base = (_sortable(pack_lanes(lanes)),
                                  self._codes_of(data))
            else:
                pk_cols = [data.column(k).to_pylist() for k in self.pk]
                part_cols = [data.column(k).to_pylist()
                             for k in self.partition_keys]
                self._ram_base = {
                    tuple(c[i] for c in pk_cols):
                        tuple(c[i] for c in part_cols)
                    for i in range(data.num_rows)}
            return
        path = os.path.join(self._index_dir(),
                            f"snapshot-{snapshot.id}.sst")
        if os.path.exists(path):
            self._reader = SstReader(path)
            return
        data, lanes = self._scan_base()
        os.makedirs(self._index_dir(), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        SstWriter().write(tmp, lanes, data)
        try:
            os.rename(tmp, path)         # atomic publish; racers agree
        except OSError:
            pass
        self._reader = SstReader(path)
        # trim spilled indexes well behind the head; a trailing window
        # stays so concurrent writers still probing a recent snapshot's
        # file never lose it mid-write
        for name in os.listdir(self._index_dir()):
            if not name.endswith(".sst"):
                continue
            try:
                sid = int(name[len("snapshot-"):-len(".sst")])
            except ValueError:
                continue
            if sid < snapshot.id - 5:
                stale = os.path.join(self._index_dir(), name)
                _GLOBAL_BLOCK_CACHE.drop_file(stale)
                try:
                    os.remove(stale)
                except OSError:
                    pass

    def _probe_sst(self, lanes: np.ndarray
                   ) -> Tuple[np.ndarray, Optional[pa.Table]]:
        try:
            return self._reader.probe(lanes)
        except FileNotFoundError:
            # a newer writer trimmed our snapshot's spilled index from
            # behind the safety window: re-bootstrap at the current
            # snapshot and retry once
            self._bootstrapped = False
            self._reader = None
            self._bootstrap_store()
            if self._reader is None:
                return np.zeros(0, np.int64), None
            return self._reader.probe(lanes)

    # -- partition codes (vectorised path) ------------------------------------

    def _codes_of(self, t: pa.Table) -> np.ndarray:
        """Partition code of each row of `t` (its partition columns)."""
        n = t.num_rows
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        dicts, idx = [], []
        for k in self.partition_keys:
            enc = t.column(k).combine_chunks().dictionary_encode(
                null_encoding="encode")
            dicts.append(enc.dictionary.to_pylist())
            idx.append(np.asarray(enc.indices))
        uniq, inverse = unique_rows(idx)
        local = np.empty(len(uniq), dtype=np.int32)
        for u, row in enumerate(uniq):
            part = tuple(dicts[j][int(v)] for j, v in enumerate(row))
            code = self._part_code.get(part)
            if code is None:
                code = self._part_code[part] = len(self._parts)
                self._parts.append(part)
            local[u] = code
        return local[inverse]

    def _with_partitions(self, t: pa.Table, codes: np.ndarray) -> pa.Table:
        """`t` with its partition columns set to the partitions of
        `codes` (keeping each field, its non-null flag included, so
        buffered batches concatenate)."""
        for j, k in enumerate(self.partition_keys):
            vals = [self._parts[c][j] for c in codes.tolist()]
            col = pa.array(vals, t.column(k).type)
            t = t.set_column(t.column_names.index(k), t.schema.field(k),
                             col)
        return t

    # -- writes --------------------------------------------------------------

    def write_arrow(self, table: pa.Table,
                    row_kinds: Optional[np.ndarray] = None):
        table, row_kinds = extract_row_kinds(table, row_kinds)
        self._bootstrap_store()
        if self._exact:
            retracts, drop = self._resolve_vectorised(table, row_kinds)
        else:
            retracts, drop = self._resolve_rows(table, row_kinds)
        if retracts is not None and retracts.num_rows:
            self.inner.write_arrow(
                retracts, np.full(retracts.num_rows, RowKind.DELETE,
                                  np.int8))
        keep = ~drop
        if not keep.all():
            table = table.filter(pa.array(keep))
            row_kinds = row_kinds[keep]
        if table.num_rows:
            self.inner.write_arrow(table, row_kinds)

    def _resolve_vectorised(self, table: pa.Table, kinds: np.ndarray
                            ) -> Tuple[Optional[pa.Table], np.ndarray]:
        """The reference's row loop, by key: rows grouped by key in
        arrival order, each row's view of its key's partition is the
        previous row's outcome (the batch-start view for the first)."""
        n = table.num_rows
        drop = np.zeros(n, dtype=bool)
        if n == 0:
            return None, drop
        lanes, _ = self._encoder.encode_table(table, self.pk)
        lanes = np.asarray(lanes)
        keys = _sortable(pack_lanes(lanes))
        newp = self._codes_of(table)
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        first = np.r_[True, ks[1:] != ks[:-1]]
        group = np.cumsum(first) - 1
        starts = np.flatnonzero(first)
        view0 = self._view(ks[starts], lanes[order[starts]])
        p = newp[order]
        retract = np.isin(kinds[order], _RETRACT_KINDS)
        after = np.where(retract, _NONE, p).astype(np.int32)
        old = np.empty(n, dtype=np.int32)
        old[first] = view0
        old[~first] = after[np.flatnonzero(~first) - 1]
        # an insert that a later row of its key moves to another
        # partition never lands: only the rows of a key's last
        # partition after its last move do
        last = np.r_[starts[1:] - 1, n - 1]
        pos = np.arange(n)
        moved = p != p[last][group]
        last_move = np.full(len(starts), -1, dtype=np.int64)
        np.maximum.at(last_move, group[moved], pos[moved])
        drop[order[(pos <= last_move[group]) & ~retract]] = True
        # the first row of each key that finds it elsewhere retracts it
        cand = np.flatnonzero((old != _NONE) & (old != p))
        cand = cand[np.r_[True, group[cand][1:] != group[cand][:-1]]] \
            if len(cand) else cand
        drop[order[cand[retract[cand]]]] = True
        # this writer's view after the batch: each key's last row
        self._overlay_update(ks[starts], after[last])
        if not len(cand):
            return None, drop
        rows = order[cand]
        by_arrival = np.argsort(rows, kind="stable")
        retracts = self._with_partitions(
            table.take(pa.array(rows[by_arrival])),
            old[cand][by_arrival])
        return retracts, drop

    def _view(self, keys: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Partition code of each (sorted, distinct) key at batch start:
        this writer's overlay first, then the base."""
        hit, out = lookup_sorted(self._ov_keys, self._ov_codes, keys)
        out[~hit] = _NONE
        idx = np.flatnonzero(~hit)
        if not len(idx):
            return out
        if self._ram_base is not None:
            found, codes = lookup_sorted(*self._ram_base, keys[idx])
            out[idx[found]] = codes[found]
        elif self._reader is not None:
            hit_pos, rows = self._probe_sst(lanes[idx])
            if rows is not None:
                out[idx[np.asarray(hit_pos, dtype=np.int64)]] = \
                    self._codes_of(rows)
        return out

    def _overlay_update(self, keys: np.ndarray, codes: np.ndarray) -> None:
        """Set this writer's view of the batch's (sorted, distinct)
        keys."""
        if not len(self._ov_keys):
            self._ov_keys, self._ov_codes = keys, codes
            return
        hit, _ = lookup_sorted(self._ov_keys, self._ov_codes, keys)
        pos = np.searchsorted(self._ov_keys, keys[hit])
        self._ov_codes[pos] = codes[hit]
        self._ov_keys, self._ov_codes = merge_sorted(
            self._ov_keys, self._ov_codes, keys[~hit], codes[~hit])

    def _resolve_rows(self, table: pa.Table, row_kinds: np.ndarray
                      ) -> Tuple[Optional[pa.Table], np.ndarray]:
        """The reference's row loop over key tuples (keys whose lanes
        may be a truncated prefix)."""
        n = table.num_rows
        pk_cols = [table.column(k).to_pylist() for k in self.pk]
        part_cols = [table.column(k).to_pylist()
                     for k in self.partition_keys]
        index = self._probe_rows(table, pk_cols)
        overlay = self._overlay

        drop = np.zeros(n, dtype=bool)   # superseded within this batch
        # key -> its in-batch inserts still to land: (i, part)
        inserts: Dict[Tuple, List[Tuple[int, Tuple]]] = {}
        retracts: Dict[Tuple, Tuple[int, Tuple]] = {}    # key -> (i, old)
        for i in range(n):
            key = tuple(c[i] for c in pk_cols)
            new_part = tuple(c[i] for c in part_cols)
            kind = int(row_kinds[i])
            # earlier in-batch INSERTs of the key in another partition
            # moved before any flush: they never materialize (the
            # reference drops only the one just before the move). Earlier
            # RETRACTS must still be written: they delete persisted rows.
            pending = inserts.get(key)
            if pending:
                for j, part in pending:
                    if part != new_part:
                        drop[j] = True
                inserts[key] = [x for x in pending if x[1] == new_part]
            persisted_old = index.get(key)
            if kind in _RETRACT_KINDS:
                # a retract routes to wherever the key actually lives
                if persisted_old is not None and \
                        persisted_old != new_part and key not in retracts:
                    retracts[key] = (i, persisted_old)
                    drop[i] = True       # rerouted copy replaces it
                index[key] = None
                overlay[key] = None
                continue
            if persisted_old is not None and persisted_old != new_part \
                    and key not in retracts:
                retracts[key] = (i, persisted_old)
            index[key] = new_part
            overlay[key] = new_part
            inserts.setdefault(key, []).append((i, new_part))
        if not retracts:
            return None, drop
        items = list(retracts.values())
        old = table.take(pa.array([i for i, _ in items]))
        for j, k in enumerate(self.partition_keys):
            col = pa.array([p[j] for _, p in items], old.column(k).type)
            old = old.set_column(old.column_names.index(k),
                                 old.schema.field(k), col)
        return old, drop

    def _probe_rows(self, table: pa.Table,
                    pk_cols) -> Dict[Tuple, Optional[Tuple]]:
        """Current partition of every key in the batch: overlay first,
        then one SST probe for the rest (confirming the full key, since
        the lanes may hold a truncated prefix)."""
        n = table.num_rows
        keys = [tuple(c[i] for c in pk_cols) for i in range(n)]
        view: Dict[Tuple, Optional[Tuple]] = {}
        need: List[int] = []
        for i, k in enumerate(keys):
            if k in view:
                continue
            if k in self._overlay:
                view[k] = self._overlay[k]
            elif self._ram_base is not None:
                view[k] = self._ram_base.get(k)
            else:
                view[k] = None
                need.append(i)
        if need and self._reader is not None:
            sub = table.take(pa.array(need)).select(self.pk)
            lanes, _ = self._encoder.encode_table(sub, self.pk)
            hit_pos, rows = self._probe_sst(np.asarray(lanes))
            if rows is not None:
                for pos, row in zip(hit_pos, rows.to_pylist()):
                    k = keys[need[int(pos)]]
                    if tuple(row[c] for c in self.pk) == k:
                        view[k] = tuple(row[c]
                                        for c in self.partition_keys)
        return view

    def prepare_commit(self):
        return self.inner.prepare_commit()

    def close(self):
        self.inner.close()
