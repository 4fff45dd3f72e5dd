"""Segmented-reduce merge engines: aggregation and partial-update.

Counterpart of paimon_tpu/ops/agg.py (reference:
mergetree/compact/PartialUpdateMergeFunction.java,
AggregateMergeFunction + 24 FieldAggregators
(mergetree/compact/aggregate/)).

The record-at-a-time accumulate loop becomes: device sort by (key, seq)
(ops/merge.py, the winner-select kernel's full variant with run codes)
-> per-key segment ids -> per-column segmented reduction on the merge's
device.  Order-based aggregates (last/first[-non-null] value, listagg,
strings) reduce to a per-segment index selection and a host-side Arrow
take, so variable-length data never goes to the card.

The reference's segment reductions are `jax.ops.segment_*`; here they
are PyTorch ops, all behind `segment_reduce`:

- integer sum, product, max and min: `scatter_reduce_` over the segment
  ids.  Integer arithmetic is exact, so the order of the card's atomic
  updates cannot change a result;
- float sum and product: `torch.segment_reduce` over the segment
  lengths, on the values as a column of width 1, which both the CPU and
  the card fold one segment per thread, row after row: the order of the
  additions is fixed, so a float sum has the same bits on every run and
  on either device;
- float max and min: the floats mapped to integers in IEEE total order
  (-0.0 below +0.0), reduced as integers and mapped back, NaN wherever
  the segment holds a NaN.  That is what the reference's XLA max and
  min give: NaN propagates, and max(-0.0, 0.0) = 0.0, min = -0.0, in
  either order.

The reference pads rows and segments to powers of two so that XLA
compiles O(log^2) shapes; torch runs every shape as it is, and the
padded rows only ever fed a dummy segment that was sliced away, so the
port does not pad.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.ops.merge import (
    KIND_COL, SEQ_COL, concat_runs, device_sorted_winners,
    user_seq_order_lanes,
)
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.options import CoreOptions, MergeEngine
from paimon_tpu_torch.schema.table_schema import TableSchema
from paimon_tpu_torch.types import RowKind

__all__ = ["merge_runs_agg", "field_aggregators", "sequence_groups",
           "aggregate_sorted_segments", "segment_reduce", "Segments"]

_NUMERIC_DEVICE_AGGS = {"sum", "max", "min", "product", "count"}


def field_aggregators(schema: TableSchema,
                      options: CoreOptions) -> Dict[str, str]:
    """Resolve per-field aggregate function from options
    (`fields.<name>.aggregate-function`), reference
    CoreOptions.fieldAggFunc."""
    default = options.options.get_or("fields.default-aggregate-function",
                                     None)
    engine = options.merge_engine
    out = {}
    pk = set(schema.primary_keys)
    for f in schema.fields:
        if f.name in pk:
            continue
        func = options.options.get_or(
            f"fields.{f.name}.aggregate-function", None)
        if func is None:
            if engine == MergeEngine.PARTIAL_UPDATE:
                func = "last_non_null_value"
            else:
                func = default or "last_non_null_value"
        out[f.name] = func
    return out


def sequence_groups(schema: TableSchema,
                    options: CoreOptions) -> Dict[str, List[str]]:
    """`fields.<a,b>.sequence-group = c,d` -> {seq_field_key: [cols]}
    (reference PartialUpdateMergeFunction sequence groups)."""
    groups = {}
    for key in options.options.keys():
        if key.startswith("fields.") and key.endswith(".sequence-group"):
            seq_fields = key[len("fields."):-len(".sequence-group")]
            cols = [c.strip()
                    for c in options.options.get(key).split(",")]
            groups[seq_fields] = cols
    return groups


def _segment_ids_from_sort(lanes, seq: np.ndarray,
                           truncated: Optional[np.ndarray] = None,
                           full_key=None, order_lanes=None,
                           packed: Optional[np.ndarray] = None,
                           run_starts: Optional[np.ndarray] = None,
                           device=None):
    """Shared device sort -> (order over real rows, segment ids, last
    row of each segment).

    If some rows' string keys exceeded the lane prefix (`truncated`),
    device segments may over-group prefix-equal keys; the affected spans
    are repaired on the host by re-sorting on the full key (`full_key`:
    row index -> comparable tuple) and splitting sub-segments."""
    n = lanes.shape[0]
    perm, winner, _ = device_sorted_winners(
        lanes, seq, "last", order_lanes, packed=packed,
        run_starts=run_starts if order_lanes is None else None,
        device=device)
    real = perm < n
    order = perm[real].astype(np.int64)
    win_sorted = winner[real]
    seg_end = win_sorted.copy()
    if len(seg_end):
        seg_end[-1] = True
    seg_id = np.concatenate([[0], np.cumsum(seg_end[:-1])]) \
        if len(seg_end) else np.zeros(0, np.int64)
    seg_id = seg_id.astype(np.int64)

    if truncated is not None and truncated.any() and full_key is not None:
        aff_ids = np.unique(seg_id[truncated[order]])
        m = len(order)
        if len(aff_ids) and m:
            # seg_id is sorted, so each affected segment is one contiguous
            # span located in O(log n); only those spans pay host work
            starts = np.searchsorted(seg_id, aff_ids, side="left")
            ends = np.searchsorted(seg_id, aff_ids, side="right")
            new_order = order.copy()
            boundaries = np.empty(m, dtype=bool)   # True = segment start
            boundaries[0] = True
            boundaries[1:] = seg_id[1:] != seg_id[:-1]
            for s, e in zip(starts, ends):
                span = order[s:e].tolist()
                fk = {r: full_key(r) for r in span}
                # within a key: user sequence first (when present), then
                # internal sequence — same order the device sort used
                resorted = sorted(
                    span,
                    key=lambda r: (fk[r],
                                   tuple(order_lanes[r])
                                   if order_lanes is not None else (),
                                   int(seq[r])))
                new_order[s:e] = resorted
                prev_key = None
                for k, r in enumerate(resorted):
                    boundaries[s + k] = (fk[r] != prev_key)
                    prev_key = fk[r]
            order = new_order
            seg_id = np.cumsum(boundaries) - 1
            win_sorted = np.empty(m, dtype=bool)
            win_sorted[:-1] = seg_id[:-1] != seg_id[1:]
            win_sorted[-1] = True
    return order, seg_id, win_sorted


# -- segment reductions on the device -----------------------------------------

class Segments:
    """The dense, ascending segment ids of one merge's sorted rows, on
    the merge's device: uploaded once and shared by every column's
    reductions."""

    def __init__(self, seg_id: np.ndarray, num_seg: int, device):
        self.num = num_seg
        self.device = device
        self.host = np.ascontiguousarray(seg_id, dtype=np.int64)
        self.ids = torch.from_numpy(self.host).to(device)
        self._lengths: Optional[torch.Tensor] = None

    def lengths(self) -> torch.Tensor:
        """Rows per segment (int64[num]), for torch.segment_reduce."""
        if self._lengths is None:
            self._lengths = torch.bincount(self.ids, minlength=self.num)
        return self._lengths


_SCATTER = {"sum": "sum", "prod": "prod", "max": "amax", "min": "amin"}


def _float_extreme(v: torch.Tensor, op: str, segs: Segments
                   ) -> torch.Tensor:
    """max/min of floats per segment, exact and independent of the
    order of the rows: reduced as integers in IEEE total order, NaN
    wherever a segment holds one."""
    itype = torch.int64 if v.dtype == torch.float64 else torch.int32
    info = torch.iinfo(itype)
    bits = v.view(itype)
    # negative floats order backwards as integers: flip all but the sign
    key = torch.where(bits < 0, bits ^ info.max, bits)
    key = torch.where(torch.isnan(v),
                      info.max if op == "max" else info.min, key)
    out = torch.zeros(segs.num, dtype=itype, device=v.device)
    out.scatter_reduce_(0, segs.ids, key, _SCATTER[op], include_self=False)
    back = torch.where(out < 0, out ^ info.max, out).view(v.dtype)
    return torch.where(torch.isnan(back), float("nan"), back)


def segment_reduce(vals: np.ndarray, op: str, segs: Segments) -> np.ndarray:
    """`op` (sum, prod, max, min) of `vals` (one per sorted row) over
    each segment, on the segments' device; numpy[num_seg] back.  Every
    segment reduction of the merge engines goes through here."""
    v = np.ascontiguousarray(vals)
    t = torch.from_numpy(v if v.flags.writeable else v.copy()) \
        .to(segs.device)
    if t.is_floating_point():
        if op in ("sum", "prod"):
            # as a column of width 1, each segment folds in one thread,
            # row after row (1-D data takes a tree reduction per segment
            # on the card, whose order differs from the CPU's)
            out = torch.segment_reduce(t.view(-1, 1), op,
                                       lengths=segs.lengths(),
                                       unsafe=True).view(-1)
        else:
            out = _float_extreme(t, op, segs)
    else:
        out = torch.zeros(segs.num, dtype=t.dtype, device=t.device)
        out.scatter_reduce_(0, segs.ids, t, _SCATTER[op], include_self=False)
    return out.cpu().numpy()


def _seg_any(mask: np.ndarray, segs: Segments) -> np.ndarray:
    """Per segment: does any row have `mask` set.  Every segment has a
    row, so an all-True mask needs no reduction."""
    if mask.all():
        return np.ones(segs.num, dtype=bool)
    return segment_reduce(mask.astype(np.int32), "max", segs) > 0


def _last_index_where(mask: np.ndarray, segs: Segments) -> np.ndarray:
    """Per segment, the position (into sorted order) of the last True;
    -1 if none. Vectorized with segment max over masked positions."""
    pos = np.arange(len(mask), dtype=np.int64)
    masked = np.where(mask, pos, -1)
    return segment_reduce(masked, "max", segs)


def _first_index_where(mask: np.ndarray, segs: Segments) -> np.ndarray:
    n = len(mask)
    pos = np.arange(n, dtype=np.int64)
    masked = np.where(mask, pos, n + 1)
    out = segment_reduce(masked, "min", segs)
    return np.where(out > n, -1, out)


def _masked_numeric(result: np.ndarray, any_valid: np.ndarray,
                    out_type: pa.DataType) -> pa.Array:
    """Vectorized (values, null-mask) -> typed Arrow array; a per-row
    `.item()` comprehension here was the agg plane's hottest line."""
    arr = pa.array(result, mask=~any_valid)
    if arr.type != out_type:
        arr = arr.cast(out_type)
    return arr


# the reference's device dtypes per Arrow type (its `_JAX_NUMERIC`),
# unchanged: narrow integers and bool widen, so sums and counts match
_JAX_NUMERIC = {
    pa.int8(): np.int32, pa.int16(): np.int32, pa.int32(): np.int64,
    pa.int64(): np.int64, pa.float32(): np.float32,
    pa.float64(): np.float64, pa.bool_(): np.int32,
}


def merge_runs_agg(runs: Sequence[pa.Table], key_cols: Sequence[str],
                   schema: TableSchema, options: CoreOptions,
                   key_encoder: Optional[NormalizedKeyEncoder] = None,
                   seq_fields: Optional[Sequence[str]] = None,
                   encoded=None, device=None) -> pa.Table:
    """Merge runs under aggregation / partial-update semantics on
    `device` (None = cuda).  Returns a KV-shaped table (keys + sys cols
    + aggregated values), sorted by key.

    `encoded`: optional (lanes, truncated[, packed]) per run, when the
    caller already lane-encoded them (streamed compaction windows)."""
    device = resolve_device(device)
    table = concat_runs(runs)
    n = table.num_rows
    if n == 0:
        return table
    if key_encoder is None:
        key_encoder = NormalizedKeyEncoder(
            [table.schema.field(k).type for k in key_cols],
            nullable=[table.schema.field(k).nullable for k in key_cols])
    if encoded is not None:
        lanes = np.concatenate([np.asarray(e[0]) for e in encoded])
        truncated = np.concatenate([np.asarray(e[1]) for e in encoded])
        packs = [e[2] if len(e) > 2 else None for e in encoded]
        packed = np.concatenate(packs) \
            if all(p is not None for p in packs) else None
        run_lens = [e[0].shape[0] for e in encoded]
    else:
        lanes, truncated, packed = key_encoder.encode_table_ex(table,
                                                               key_cols)
        run_lens = [r.num_rows for r in runs]
    seq = np.asarray(table.column(SEQ_COL).combine_chunks().cast(pa.int64()))
    full_key = None
    if truncated.any():
        kcols = [table.column(k) for k in key_cols]

        def full_key(i: int):
            return tuple(c[int(i)].as_py() for c in kcols)

    order_lanes = user_seq_order_lanes(
        table, seq_fields, options.sequence_field_descending) \
        if seq_fields else None
    run_starts = np.concatenate([[0], np.cumsum(run_lens)]).astype(np.int64)
    order, seg_id, win_sorted = _segment_ids_from_sort(
        lanes, seq, truncated, full_key, order_lanes, packed=packed,
        run_starts=run_starts, device=device)
    return aggregate_sorted_segments(table, order, seg_id, win_sorted,
                                     key_cols, schema, options,
                                     device=device)


def aggregate_sorted_segments(table: pa.Table, order: np.ndarray,
                              seg_id: np.ndarray, win_sorted: np.ndarray,
                              key_cols: Sequence[str],
                              schema: TableSchema,
                              options: CoreOptions,
                              device=None) -> pa.Table:
    """Engine-parameterized aggregation epilogue of ``merge_runs_agg``;
    the segment reductions run on `device` (None = cuda).

    `order`: positions into `table` in (key, user-seq, seq, arrival)
    order; `seg_id`: per-sorted-row key-segment id (ascending, dense);
    `win_sorted`: True at the last row of each segment.  Folds every
    segment per the table's merge engine and returns the KV-shaped
    merged rows in key order."""
    num_seg = int(seg_id[-1]) + 1 if len(seg_id) else 0
    segs = Segments(seg_id, num_seg, resolve_device(device))
    win_pos = np.flatnonzero(win_sorted)           # last row of each segment

    sorted_tbl = table.take(pa.array(order))
    kinds_sorted = np.asarray(sorted_tbl.column(KIND_COL).combine_chunks()
                              .cast(pa.int8()))
    retract = (kinds_sorted == RowKind.DELETE) | \
              (kinds_sorted == RowKind.UPDATE_BEFORE)

    aggs = field_aggregators(schema, options)
    remove_on_delete = options.get(
        CoreOptions.PARTIAL_UPDATE_REMOVE_RECORD_ON_DELETE)

    out_cols: Dict[str, pa.Array] = {}
    # keys + sequence + kind from the segment winner row
    for name in list(key_cols) + [SEQ_COL, KIND_COL]:
        out_cols[name] = sorted_tbl.column(name).take(pa.array(win_pos))

    add_mask = ~retract

    # sequence groups (partial-update): each group's member columns take
    # their values from the row with the LARGEST group-sequence value
    # instead of the global sequence order (reference
    # PartialUpdateMergeFunction sequence groups; ties -> later row wins)
    seq_group_idx: Dict[str, np.ndarray] = {}
    if options.merge_engine == MergeEngine.PARTIAL_UPDATE:
        for gkey, cols in sequence_groups(schema, options).items():
            seq_fields = [s.strip() for s in gkey.split(",")]
            idx = _seq_group_winner_index(sorted_tbl, seq_fields, segs,
                                          add_mask)
            for colname in dict.fromkeys(list(cols) + seq_fields):
                if options.options.get_or(
                        f"fields.{colname}.aggregate-function",
                        None) is not None:
                    raise NotImplementedError(
                        f"aggregate-function on sequence-group member "
                        f"{colname!r} (reference: aggregation within "
                        f"sequence groups) is not supported yet")
                seq_group_idx[colname] = idx

    for f in schema.fields:
        name = f.name
        col_sorted = sorted_tbl.column(name)
        if name not in aggs:   # key column: winner value
            out_cols[name] = col_sorted.take(pa.array(win_pos))
            continue
        if name in seq_group_idx:
            idx = seq_group_idx[name]
            taken = col_sorted.take(pa.array(np.where(idx < 0, 0, idx)))
            nulls = pa.array(idx < 0)
            out_cols[name] = pc.if_else(
                nulls, pa.nulls(num_seg, taken.type),
                taken.combine_chunks())
            continue
        func = aggs[name]
        valid = np.asarray(pc.is_valid(col_sorted.combine_chunks()))
        if func in _NUMERIC_DEVICE_AGGS and \
                col_sorted.type in _JAX_NUMERIC:
            np_dtype = _JAX_NUMERIC[col_sorted.type]
            vals = np.asarray(col_sorted.combine_chunks()
                              .fill_null(0)).astype(np_dtype)
            contrib_mask = valid & add_mask
            if func == "count":
                result = segment_reduce(contrib_mask.astype(np.int64),
                                        "sum", segs)
                out_cols[name] = pa.array(result, pa.int64())
                continue
            if func == "sum":
                ignore_retract = options.options.get_or(
                    f"fields.{name}.ignore-retract", "false") == "true"
                if ignore_retract:
                    # reference FieldIgnoreRetractAgg: retracts are
                    # no-ops instead of subtracting, and do not count
                    # as a contribution (all-retract segment -> null)
                    signed = np.where(retract, 0, vals)
                    contributed = valid & ~retract
                else:
                    signed = np.where(retract, -vals, vals)
                    contributed = valid
                signed = np.where(valid, signed, 0)
                result = segment_reduce(signed, "sum", segs)
                out_cols[name] = _masked_numeric(
                    result, _seg_any(contributed, segs), col_sorted.type)
                continue
            if func in ("max", "min", "product"):
                ident = {"max": _np_min_ident(np_dtype),
                         "min": _np_max_ident(np_dtype),
                         "product": np_dtype(1)}[func]
                masked = np.where(contrib_mask, vals, ident)
                result = segment_reduce(
                    masked, "prod" if func == "product" else func, segs)
                out_cols[name] = _masked_numeric(
                    result, _seg_any(contrib_mask, segs), col_sorted.type)
                continue
        # order-based aggregates: pick an index per segment, host gather
        if func == "last_non_null_value":
            idx = _last_index_where(valid & add_mask, segs)
        elif func == "last_value":
            idx = _last_index_where(add_mask, segs)
        elif func == "first_non_null_value":
            idx = _first_index_where(valid & add_mask, segs)
        elif func == "first_value":
            idx = _first_index_where(add_mask, segs)
        elif func == "listagg":
            out_cols[name] = _listagg(col_sorted, valid & add_mask, seg_id,
                                      num_seg, options, name)
            continue
        elif func == "collect":
            if not pa.types.is_list(col_sorted.type) and \
                    not pa.types.is_large_list(col_sorted.type):
                raise ValueError(
                    f"collect aggregate requires field {name!r} to be "
                    f"declared ARRAY<...>, got {f.type} (reference "
                    f"FieldCollectAgg)")
            out_cols[name] = _collect(col_sorted, valid & add_mask, seg_id,
                                      num_seg, options, name)
            continue
        elif func == "merge_map":
            out_cols[name] = _merge_map(col_sorted, valid & add_mask,
                                        seg_id, num_seg)
            continue
        elif func == "primary_key":
            # reference FieldPrimaryKeyAgg: the first value sticks
            idx = _first_index_where(valid & add_mask, segs)
        elif func in ("rbm32", "rbm64"):
            out_cols[name] = _rbm_agg(col_sorted, valid & add_mask,
                                      seg_id, num_seg, func, name)
            continue
        elif func in ("hll_sketch", "theta_sketch"):
            out_cols[name] = _sketch_agg(col_sorted, valid & add_mask,
                                         seg_id, num_seg, func, name)
            continue
        elif func == "nested_update":
            out_cols[name] = _nested_update(col_sorted, valid & add_mask,
                                            seg_id, num_seg, options,
                                            name, f)
            continue
        elif func in ("bool_and", "bool_or"):
            vals = np.asarray(col_sorted.combine_chunks()
                              .fill_null(func == "bool_and"))
            if func == "bool_or":
                masked = vals & (valid & add_mask)
            else:
                masked = vals | ~(valid & add_mask)
            result = segment_reduce(masked.astype(np.int32),
                                    "max" if func == "bool_or" else "min",
                                    segs)
            out_cols[name] = pa.array(result.astype(bool), pa.bool_())
            continue
        else:
            raise ValueError(f"Unknown aggregate function {func!r} "
                             f"for field {name}")
        taken = col_sorted.take(pa.array(np.where(idx < 0, 0, idx)))
        nulls = pa.array(idx < 0)
        out_cols[name] = pc.if_else(nulls, pa.nulls(num_seg, taken.type),
                                    taken.combine_chunks())

    out = pa.table(out_cols)
    # delete handling: drop segments whose winner is a retract
    winner_kinds = np.asarray(out.column(KIND_COL).combine_chunks()
                              .cast(pa.int8()))
    if options.merge_engine == MergeEngine.PARTIAL_UPDATE \
            and not remove_on_delete:
        return out  # deletes ignored (retracts folded per column)
    drop = (winner_kinds == RowKind.DELETE)
    if drop.any():
        out = out.filter(pa.array(~drop))
    return out


def _seq_group_winner_index(sorted_tbl: pa.Table, seq_fields: List[str],
                            segs: Segments,
                            add_mask: np.ndarray) -> np.ndarray:
    """Per segment: position (into sorted order) of the row with the
    largest non-null group-sequence tuple; -1 if no row qualifies.
    Rows with any null sequence field never update the group (reference
    PartialUpdateMergeFunction: null sequence -> skip)."""
    n = sorted_tbl.num_rows
    valid = np.ones(n, dtype=bool)
    mats = []
    for fname in seq_fields:
        arr = sorted_tbl.column(fname).combine_chunks()
        valid &= np.asarray(pc.is_valid(arr))
        t = arr.type
        if pa.types.is_date32(t) or pa.types.is_time32(t):
            # 32-bit temporals -> int64 is not a direct arrow cast
            vals = np.asarray(arr.cast(pa.int32()).fill_null(0)) \
                .astype(np.int64)
        elif pa.types.is_integer(t) or pa.types.is_temporal(t):
            vals = np.asarray(arr.cast(pa.int64()).fill_null(0))
        elif pa.types.is_floating(t):
            vals = np.asarray(arr.cast(pa.float64()).fill_null(0))
        elif pa.types.is_decimal(t):
            vals = np.array([0 if v is None else int(v.scaleb(t.scale))
                             for v in arr.to_pylist()], dtype=object)
        else:
            raise ValueError(
                f"sequence-group field {fname!r} must be numeric or "
                f"temporal, got {t}")
        # rank per field on its native dtype (no cross-field upcasting,
        # which would collapse int64 values above 2^53 into float64)
        _, field_rank = np.unique(vals, return_inverse=True)
        mats.append(field_rank.astype(np.int64))
    # order-preserving combined rank with tie equality
    stacked = np.stack(mats, axis=1)
    _, rank = np.unique(stacked, axis=0, return_inverse=True)
    mask = valid & add_mask
    masked = np.where(mask, rank.reshape(-1).astype(np.int64), -1)
    mx = segment_reduce(masked, "max", segs)[segs.host]
    is_max = mask & (masked == mx) & (mx >= 0)
    return _last_index_where(is_max, segs)


def _collect(col_sorted, mask, seg_id, num_seg, options, name):
    """reference aggregate/FieldCollectAgg: gather values into an array
    (fields.<name>.distinct=true dedups)."""
    distinct = options.options.get_or(f"fields.{name}.distinct",
                                      "false") == "true"
    vals = col_sorted.to_pylist()
    acc: List[Optional[list]] = [None] * num_seg
    for i in np.flatnonzero(mask):
        g = seg_id[i]
        if acc[g] is None:
            acc[g] = []
        v = vals[i]
        if isinstance(v, list):
            acc[g].extend(v)
        else:
            acc[g].append(v)
    if distinct:
        def _dedup(a):
            try:
                return list(dict.fromkeys(a))
            except TypeError:       # unhashable elements (nested types)
                seen, out = set(), []
                for v in a:
                    r = repr(v)
                    if r not in seen:
                        seen.add(r)
                        out.append(v)
                return out
        acc = [None if a is None else _dedup(a) for a in acc]
    return pa.array(acc, col_sorted.type if pa.types.is_list(
        col_sorted.type) else pa.list_(col_sorted.type))


def _seg_bounds(seg_id: np.ndarray, num_seg: int):
    """[start, end) of each segment in the (seg-sorted) row order."""
    starts = np.searchsorted(seg_id, np.arange(num_seg))
    ends = np.searchsorted(seg_id, np.arange(num_seg), side="right")
    return starts, ends


def _rbm_agg(col_sorted, mask, seg_id, num_seg, func: str, name: str):
    """Roaring-bitmap OR-union aggregate over pre-serialized bitmap
    blobs (reference FieldRoaringBitmap32Agg / FieldRoaringBitmap64Agg;
    wire format index/roaring.py)."""
    from paimon_tpu_torch.index.roaring import (
        deserialize_roaring32, deserialize_roaring64,
        serialize_roaring32, serialize_roaring64,
    )
    deser = deserialize_roaring32 if func == "rbm32" \
        else deserialize_roaring64
    ser = serialize_roaring32 if func == "rbm32" else serialize_roaring64
    t = col_sorted.type
    if not (pa.types.is_binary(t) or pa.types.is_large_binary(t)):
        raise ValueError(f"{func} aggregate requires field {name!r} to "
                         f"be VARBINARY of serialized bitmaps")
    vals = col_sorted.combine_chunks().to_pylist()
    starts, ends = _seg_bounds(seg_id, num_seg)
    out = []
    for s, e in zip(starts, ends):
        parts = [deser(vals[i]) for i in range(s, e)
                 if mask[i] and vals[i] is not None]
        out.append(None if not parts
                   else bytes(ser(np.unique(np.concatenate(parts)))))
    return pa.array(out, t)


def _sketch_agg(col_sorted, mask, seg_id, num_seg, func: str, name: str):
    """HLL / theta sketch union aggregate (reference FieldHllSketchAgg,
    FieldThetaSketchAgg; wire format ops/sketch.py)."""
    from paimon_tpu_torch.ops.sketch import hll_union, theta_union
    union = hll_union if func == "hll_sketch" else theta_union
    t = col_sorted.type
    if not (pa.types.is_binary(t) or pa.types.is_large_binary(t)):
        raise ValueError(f"{func} aggregate requires field {name!r} to "
                         f"be VARBINARY of serialized sketches")
    vals = col_sorted.combine_chunks().to_pylist()
    starts, ends = _seg_bounds(seg_id, num_seg)
    out = []
    for s, e in zip(starts, ends):
        merged = union(vals[i] for i in range(s, e)
                       if mask[i] and vals[i] is not None)
        out.append(merged)
    return pa.array(out, t)


def _nested_update(col_sorted, mask, seg_id, num_seg, options,
                   name: str, field):
    """ARRAY<ROW> accumulation (reference FieldNestedUpdateAgg):
    concatenate nested rows across versions; with
    `fields.<name>.nested-key = a,b` rows dedup by that key, last
    writer wins."""
    t = col_sorted.type
    if not (pa.types.is_list(t) or pa.types.is_large_list(t)) or \
            not pa.types.is_struct(t.value_type):
        raise ValueError(f"nested_update requires field {name!r} to be "
                         f"ARRAY<ROW<...>>, got {field.type}")
    keys_opt = options.options.get_or(f"fields.{name}.nested-key", None)
    nested_keys = [k.strip() for k in keys_opt.split(",")] \
        if keys_opt else None
    if nested_keys:
        struct_fields = {t.value_type.field(i).name
                         for i in range(t.value_type.num_fields)}
        unknown = [k for k in nested_keys if k not in struct_fields]
        if unknown:
            raise ValueError(
                f"fields.{name}.nested-key names {unknown} not in the "
                f"nested row {sorted(struct_fields)} (reference "
                f"FieldNestedUpdateAgg key resolution)")
    vals = col_sorted.combine_chunks().to_pylist()
    starts, ends = _seg_bounds(seg_id, num_seg)
    out = []
    for s, e in zip(starts, ends):
        acc: list = []
        seen = {}
        any_val = False
        for i in range(s, e):
            if not mask[i] or vals[i] is None:
                continue
            any_val = True
            for row in vals[i]:
                if nested_keys is None:
                    acc.append(row)
                    continue
                k = tuple(row.get(c) for c in nested_keys)
                if k in seen:
                    acc[seen[k]] = row    # in-place update keeps order
                else:
                    seen[k] = len(acc)
                    acc.append(row)
        out.append(acc if any_val else None)
    return pa.array(out, t)


def _merge_map(col_sorted, mask, seg_id, num_seg):
    """reference aggregate/FieldMergeMapAgg: later maps overwrite earlier
    keys."""
    vals = col_sorted.to_pylist()
    acc: List[Optional[dict]] = [None] * num_seg
    for i in np.flatnonzero(mask):
        g = seg_id[i]
        v = vals[i]
        if v is None:
            continue
        if acc[g] is None:
            acc[g] = {}
        acc[g].update(dict(v))
    return pa.array([None if a is None else list(a.items()) for a in acc],
                    col_sorted.type)


def _listagg(col_sorted, mask, seg_id, num_seg, options, name):
    sep = options.options.get_or(f"fields.{name}.list-agg-delimiter", ",")
    vals = col_sorted.to_pylist()
    acc: List[Optional[str]] = [None] * num_seg
    for i in np.flatnonzero(mask):
        s = vals[i]
        g = seg_id[i]
        acc[g] = s if acc[g] is None else acc[g] + sep + s
    return pa.array(acc, pa.string())


def _np_min_ident(dt):
    if np.issubdtype(dt, np.integer):
        return np.iinfo(dt).min
    return dt(-np.inf)


def _np_max_ident(dt):
    if np.issubdtype(dt, np.integer):
        return np.iinfo(dt).max
    return dt(np.inf)
