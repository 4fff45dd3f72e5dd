"""Sorted key -> row-id global index for row-tracked append tables.

Counterpart of paimon_tpu/index/global_index.py; its parquet run and
meta.json are the reference's byte for byte.  The build's key sort runs
on the table's device: the key column's order-preserving lanes
(ops/normkey.py) are ranked there (ops/diff.py `_device_ranks`: a stable
lane sort and the neighbour-equality mask, the CUDA kernel on the card)
and the ranks sorted stably, which is the order of `pc.sort_indices`
exactly, ties in input order.  Where the lanes order differently from
pyarrow, the lanes are mended first: -0.0 equals 0.0 and every NaN is
one value above +inf (the lanes keep their bits apart), and a string or
binary key longer than the 16-byte prefix, or holding a zero byte (the
lanes pad with zeros), gets a full-value rank as a last lane.  Nulls
sort last through the encoder's presence lane.  Only the permutation
comes back to the host.

reference: paimon-common/src/main/java/org/apache/paimon/globalindex/
sorted/ (sorted run files probed by binary search) and btree/ (the
B+-tree variant); union/offset readers combine runs.  Here one sorted
columnar run per build stands for them: lookups are
a single vectorized np.searchsorted over the key column — one probe
per query key, no tree walks — and rebuilds are a full-column sort on
the device.

Layout: `{table}/index/global/{column}/index-{snapshot_id}.parquet`
holding (key, row_id) sorted by key, plus `meta.json` recording the
snapshot the index was built from (stale indexes rebuild lazily).
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

__all__ = ["SortedGlobalIndex", "sort_indices"]


def _full_value_ranks(keys: pa.Array, marked: np.ndarray) -> np.ndarray:
    """int64[N]: 1 + the rank of each marked row's full value among the
    marked rows (byte order, as pyarrow's), 0 elsewhere."""
    extra = np.zeros(len(keys), dtype=np.int64)
    idx = np.flatnonzero(marked)
    vals = keys.take(pa.array(idx)).to_pylist()
    rank_of = {v: r + 1 for r, v in enumerate(sorted(set(vals)))}
    extra[idx] = [rank_of[v] for v in vals]
    return extra


def sort_indices(keys: pa.Array, device) -> np.ndarray:
    """int64 permutation equal to `pc.sort_indices(keys)` (ascending,
    nulls last, NaN after every number, ties in input order), computed
    on `device`."""
    import torch

    from paimon_tpu_torch.ops.diff import _device_ranks
    from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder

    if isinstance(keys, pa.ChunkedArray):
        keys = keys.combine_chunks()
    if len(keys) == 0:
        return np.zeros(0, dtype=np.int64)
    enc_keys, extra = keys, None
    if pa.types.is_temporal(keys.type):
        # dates, times and timestamps order as their integer storage
        enc_keys = keys.view(pa.int32() if keys.type.bit_width == 32
                             else pa.int64())
    elif pa.types.is_floating(keys.type):
        vals = np.asarray(keys.cast(pa.float64()).fill_null(0.0))
        vals = np.where(vals == 0.0, 0.0, vals)           # -0.0 == 0.0
        vals = np.where(np.isnan(vals), np.nan, vals)     # one NaN
        enc_keys = pa.array(vals, pa.float64(),
                            mask=np.asarray(keys.is_null()))
    enc = NormalizedKeyEncoder([enc_keys.type])
    lanes, truncated = enc.encode_columns([enc_keys])
    t = keys.type
    if pa.types.is_string(t) or pa.types.is_large_string(t) or \
            pa.types.is_binary(t) or pa.types.is_large_binary(t):
        marked = truncated | np.asarray(
            pc.fill_null(pc.match_substring(
                keys.cast(pa.large_binary()), "\x00"), False))
        if marked.any():
            extra = _full_value_ranks(keys, marked)
    ranks = _device_ranks([np.asarray(lanes)], extra, device)
    return torch.sort(ranks, stable=True).indices.cpu().numpy()


class SortedGlobalIndex:
    def __init__(self, table, column: str, keys: pa.Array,
                 row_ids: np.ndarray, snapshot_id: int):
        self.table = table
        self.column = column
        self.keys = keys                  # sorted
        self.row_ids = row_ids            # aligned to keys
        self.snapshot_id = snapshot_id
        self._np_keys = None

    # -- build / persist -----------------------------------------------------

    @staticmethod
    def _dir(table, column: str) -> str:
        return f"{table.path}/index/global/{column}"

    @classmethod
    def load_or_build(cls, table, column: str,
                      rebuild: bool = False) -> "SortedGlobalIndex":
        latest = table.latest_snapshot()
        if latest is None:
            raise ValueError("empty table has no index")
        d = cls._dir(table, column)
        meta_path = f"{d}/meta.json"
        if not rebuild:
            try:
                meta = json.loads(table.file_io.read_bytes(meta_path))
                if meta["snapshot_id"] == latest.id and \
                        meta["column"] == column:
                    import io as _io
                    import pyarrow.parquet as pq
                    data = table.file_io.read_bytes(
                        f"{d}/{meta['file']}")
                    t = pq.read_table(_io.BytesIO(data))
                    return cls(table, column,
                               t.column("key").combine_chunks(),
                               np.asarray(t.column("row_id")),
                               meta["snapshot_id"])
            except (FileNotFoundError, OSError, KeyError):
                pass
        return cls.build(table, column)

    @classmethod
    def build(cls, table, column: str) -> "SortedGlobalIndex":
        from paimon_tpu_torch.core.row_tracking import ROW_ID_COL
        latest = table.latest_snapshot()
        t = table.to_arrow(projection=[column], with_row_ids=True)
        # files written before row-tracking.enabled have no ids — they
        # cannot be indexed, so they drop out rather than poison the run
        t = t.filter(pc.is_valid(t.column(ROW_ID_COL)))
        keys = t.column(column).combine_chunks()
        rids = np.asarray(t.column(ROW_ID_COL).combine_chunks()
                          .cast(pa.int64()))
        order = sort_indices(keys, table.device)
        keys = keys.take(pa.array(order))
        rids = rids[order]

        import io as _io
        import pyarrow.parquet as pq
        buf = _io.BytesIO()
        pq.write_table(pa.table({"key": keys,
                                 "row_id": pa.array(rids, pa.int64())}),
                       buf)
        d = cls._dir(table, column)
        fname = f"index-{latest.id}.parquet"
        table.file_io.write_bytes(f"{d}/{fname}", buf.getvalue(),
                                  overwrite=True)
        table.file_io.write_bytes(
            f"{d}/meta.json",
            json.dumps({"snapshot_id": latest.id, "column": column,
                        "file": fname,
                        "num_rows": len(rids)}).encode(),
            overwrite=True)
        return cls(table, column, keys, rids, latest.id)

    # -- lookups -------------------------------------------------------------

    def _np(self) -> np.ndarray:
        if self._np_keys is None:
            self._np_keys = np.asarray(self.keys)
        return self._np_keys

    def lookup(self, values: Sequence) -> np.ndarray:
        """First row id per query value (-1 = absent), one vectorized
        searchsorted for the whole batch."""
        ks = self._np()
        q = np.asarray(list(values), dtype=ks.dtype if len(ks) else None)
        if len(ks) == 0:
            return np.full(len(q), -1, dtype=np.int64)
        pos = np.searchsorted(ks, q, side="left")
        pos_c = np.minimum(pos, len(ks) - 1)
        hit = (pos < len(ks)) & (ks[pos_c] == q)
        out = np.where(hit, self.row_ids[pos_c], -1)
        return out.astype(np.int64)

    def lookup_all(self, value) -> np.ndarray:
        """Every row id bearing `value` (duplicate keys allowed)."""
        ks = self._np()
        lo = np.searchsorted(ks, value, side="left")
        hi = np.searchsorted(ks, value, side="right")
        return self.row_ids[lo:hi].astype(np.int64)
