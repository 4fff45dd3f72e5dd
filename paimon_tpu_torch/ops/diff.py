"""Keyed diff of two merged (key-unique) KV tables -> changelog rows.

Counterpart of paimon_tpu/ops/diff.py, the data-parallel heart of the
compaction changelog producers:

- changelog-producer=full-compaction diffs the previous top level against
  the new full-compaction result (reference
  FullChangelogMergeTreeCompactRewriter / FullChangelogMergeFunctionWrapper)
- changelog-producer=lookup diffs the pre-compaction visible state of
  levels >0 against the post-compaction state, restricted to the keys
  touched by the incoming L0 records (reference
  LookupChangelogMergeFunctionWrapper.java:54 + LookupLevels.lookup)

Keys are compared via JOINT integer ranks: equal keys of every input
table share a dense rank, and rank order is key order.  The reference
takes them from one host np.unique(axis=0) over all key lanes; here the
host only encodes the lanes, and the ranks come from the device: the
merge's stable lexicographic sort (ops/merge._stable_argsort), the
neighbour-equality mask over the sorted lanes (kernels.eq_next_mask, the
CUDA kernel on the card) and the exclusive running count of key changes,
scattered back through the permutation.  Prefix-truncated string keys
get a disambiguation column ranked on the full key, sorted last as two
more lanes.  The ranks equal np.unique's inverse exactly
(`joint_key_ranks_plain` keeps the numpy computation for the tests).

The alignment (isin, searchsorted) runs on the same device; only the row
index vectors come back for Arrow's take, and the value comparison stays
Arrow compute per column.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.ops.kernels import eq_next_mask
from paimon_tpu_torch.ops.merge import (
    KIND_COL, _lane_sort_keys, _split_i64, _stable_argsort, _writable,
)
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.types import RowKind

__all__ = ["joint_key_ranks", "joint_key_ranks_plain",
           "keyed_changelog_diff"]


def _disambiguation_ranks(tables: Sequence[pa.Table],
                          key_cols: Sequence[str],
                          trunc_list: Sequence[np.ndarray]
                          ) -> Optional[np.ndarray]:
    """int64[N] full-key sub-ranks (1-based) of the prefix-truncated rows
    of all tables, 0 elsewhere; None when no key was truncated.  A Python
    loop over the truncated rows, as in the reference."""
    if not any(trunc.any() for trunc in trunc_list):
        return None
    fulls = []
    for t, trunc in zip(tables, trunc_list):
        if not trunc.any():
            continue
        cols = [t.column(c) for c in key_cols]
        for i in np.flatnonzero(trunc):
            fulls.append(tuple(str(c[int(i)].as_py()) for c in cols))
    rank_of = {k: r + 1 for r, k in enumerate(sorted(set(fulls)))}
    extra = np.zeros(sum(len(trunc) for trunc in trunc_list), np.int64)
    pos = 0
    fi = 0
    for trunc in trunc_list:
        for i in np.flatnonzero(trunc):
            extra[pos + int(i)] = rank_of[fulls[fi]]
            fi += 1
        pos += len(trunc)
    return extra


def _encode_lanes(tables: Sequence[pa.Table], key_cols: Sequence[str],
                  encoder: NormalizedKeyEncoder
                  ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """Host side of the ranks: per table its key lanes (the packed u64 of
    a single fixed-width key, else uint32[n, L]), and the disambiguation
    ranks of truncated keys (or None)."""
    parts, trunc_list = [], []
    for t in tables:
        lanes, trunc, packed = encoder.encode_table_ex(t, key_cols)
        parts.append(packed if packed is not None else np.asarray(lanes))
        trunc_list.append(trunc)
    return parts, _disambiguation_ranks(tables, key_cols, trunc_list)


def _device_ranks(parts: Sequence[np.ndarray], extra: Optional[np.ndarray],
                  device: torch.device) -> torch.Tensor:
    """Dense joint ranks (int64[N], on `device`) of the rows of `parts`
    in order: upload, stable lexicographic sort, the neighbour-equality
    mask over the sorted lanes, exclusive running count of key changes,
    scatter through the permutation."""
    cols = []
    for p in parts:
        if not len(p):
            continue
        if p.ndim == 1:
            hi, lo = _split_i64(torch.from_numpy(
                _writable(p, np.uint64).view(np.int64)).to(device))
            cols.append(torch.stack([hi, lo]))
        else:
            cols.append(torch.from_numpy(
                _writable(p, np.uint32).view(np.int32)).to(device).T)
    if not cols:
        return torch.zeros(0, dtype=torch.int64, device=device)
    lanes = torch.cat(cols, dim=1)
    if extra is not None:
        # least significant: sorted after every key lane
        hi, lo = _split_i64(torch.from_numpy(extra).to(device))
        lanes = torch.cat([lanes, torch.stack([hi, lo])])
    num_lanes, n = lanes.shape
    perm = _stable_argsort(_lane_sort_keys(list(lanes)))
    # invalid rows pad the sorted lanes to a multiple of 4, so every lane
    # row starts 16-byte aligned and the kernel takes its vector path;
    # the last real row never continues into the padding
    m = -(-n // 4) * 4
    s_lanes = torch.zeros((num_lanes, m), dtype=torch.int32, device=device)
    s_lanes[:, :n] = lanes.index_select(1, perm)
    invalid = torch.ones(m, dtype=torch.int32, device=device)
    invalid[:n] = 0
    ends = (~eq_next_mask(s_lanes, invalid)[:n]).to(torch.int64)
    ranks = torch.empty_like(ends)
    ranks[perm] = torch.cumsum(ends, 0) - ends
    return ranks


def _sizes(tables: Sequence[pa.Table]) -> List[int]:
    return [t.num_rows for t in tables]


def joint_key_ranks(tables: Sequence[pa.Table], key_cols: Sequence[str],
                    encoder: NormalizedKeyEncoder,
                    device=None) -> List[np.ndarray]:
    """Rank the keys of several tables in ONE order-preserving space on
    `device` (None = cuda): equal keys (across tables) share a rank; rank
    order == key order; ranks are dense from 0 (np.unique's inverse).
    Truncated string keys are disambiguated by full-key sub-ranks."""
    parts, extra = _encode_lanes(tables, key_cols, encoder)
    ranks = _device_ranks(parts, extra, resolve_device(device))
    return [r.numpy() for r in
            torch.split(ranks.cpu(), _sizes(tables))]


def joint_key_ranks_plain(tables: Sequence[pa.Table],
                          key_cols: Sequence[str],
                          encoder: NormalizedKeyEncoder
                          ) -> List[np.ndarray]:
    """The reference's numpy computation of `joint_key_ranks`: one
    np.unique(axis=0) over every table's lanes and the disambiguation
    column (kept for the tests)."""
    lanes_list, trunc_list = [], []
    for t in tables:
        lanes, trunc = encoder.encode_table(t, key_cols)
        lanes_list.append(lanes)
        trunc_list.append(trunc)
    all_lanes = np.concatenate(lanes_list) if lanes_list else \
        np.zeros((0, encoder.num_lanes), np.uint32)
    extra = _disambiguation_ranks(tables, key_cols, trunc_list)
    if extra is None:
        extra = np.zeros(len(all_lanes), np.int64)
    mat = np.concatenate([all_lanes.astype(np.int64), extra[:, None]],
                         axis=1)
    _, inv = np.unique(mat, axis=0, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    return np.split(inv, np.cumsum(_sizes(tables))[:-1])


def _diff_indices(before: pa.Table, after: pa.Table,
                  restrict_table: Optional[pa.Table],
                  key_cols: Sequence[str], encoder: NormalizedKeyEncoder,
                  device: torch.device) -> Tuple[np.ndarray, ...]:
    """Row indices into `before` / `after` (ascending) of the deleted
    keys, the inserted keys, and the matched pairs (after, before),
    restricted to the keys of `restrict_table` when given; computed on
    `device`, returned as numpy."""
    tables = [before, after] + ([restrict_table]
                                if restrict_table is not None else [])
    parts, extra = _encode_lanes(tables, key_cols, encoder)
    ranks = torch.split(_device_ranks(parts, extra, device), _sizes(tables))
    rk_before, rk_after = ranks[0], ranks[1]
    idx_b = torch.arange(len(rk_before), device=device)
    idx_a = torch.arange(len(rk_after), device=device)
    if restrict_table is not None:
        allowed = torch.unique(ranks[2])
        keep_b = torch.isin(rk_before, allowed)
        keep_a = torch.isin(rk_after, allowed)
        idx_b, rk_before = idx_b[keep_b], rk_before[keep_b]
        idx_a, rk_after = idx_a[keep_a], rk_after[keep_a]

    # align: both inputs are key-sorted and key-unique
    pos = torch.searchsorted(rk_before, rk_after)
    pos_clipped = torch.clamp(pos, max=max(len(rk_before) - 1, 0))
    in_before = torch.zeros(len(rk_after), dtype=torch.bool, device=device)
    if len(rk_before):
        in_before = rk_before[pos_clipped] == rk_after
    matched_before_pos = pos_clipped[in_before]
    only_before = torch.ones(len(rk_before), dtype=torch.bool,
                             device=device)
    only_before[matched_before_pos] = False
    return tuple(t.cpu().numpy() for t in (
        idx_b[only_before], idx_a[~in_before], idx_a[in_before],
        idx_b[matched_before_pos]))


def _values_differ(a_m: pa.Table, b_m: pa.Table,
                   value_cols: Sequence[str]) -> np.ndarray:
    """Per matched pair, whether any value column changed: two nulls and
    an unchanged NaN count as equal."""
    differs = np.zeros(a_m.num_rows, dtype=bool)
    for c in value_cols:
        ca = a_m.column(c).combine_chunks()
        cb = b_m.column(c).combine_chunks()
        eq = pc.equal(ca, cb)
        both_null = pc.and_(pc.is_null(ca), pc.is_null(cb))
        same = pc.or_kleene(eq, both_null)
        if pa.types.is_floating(ca.type):
            # NaN != NaN under IEEE; an unchanged NaN is not a diff
            both_nan = pc.and_(pc.is_nan(ca.fill_null(0.0)),
                               pc.is_nan(cb.fill_null(0.0)))
            same = pc.or_kleene(same, both_nan)
        differs |= ~np.asarray(same.fill_null(False))
    return differs


def keyed_changelog_diff(before: Optional[pa.Table], after: pa.Table,
                         key_cols: Sequence[str],
                         encoder: NormalizedKeyEncoder,
                         value_cols: Sequence[str],
                         restrict_table: Optional[pa.Table] = None,
                         device=None) -> pa.Table:
    """Diff two key-unique KV tables (same KV layout) into changelog rows
    with _VALUE_KIND set to +I / -U / +U / -D, ranking keys on `device`
    (None = cuda).

    `restrict_table`: optional KV table; only keys occurring in it are
    diffed (the lookup producer's "keys touched by L0").
    Output: -D rows, then +I rows, then each -U immediately before its
    +U, row for row as the reference emits them."""
    if before is None:
        before = after.slice(0, 0)
    del_idx, ins_idx, am_idx, bm_idx = _diff_indices(
        before, after, restrict_table, key_cols, encoder,
        resolve_device(device))
    deletes = before.take(pa.array(del_idx))
    inserts = after.take(pa.array(ins_idx))
    # matched keys: emit -U/+U only when the value actually changed
    a_m = after.take(pa.array(am_idx))
    b_m = before.take(pa.array(bm_idx))
    if a_m.num_rows:
        differs = pa.array(_values_differ(a_m, b_m, value_cols))
        a_m = a_m.filter(differs)
        b_m = b_m.filter(differs)

    def _with_kind(t: pa.Table, kind: int) -> pa.Table:
        kinds = pa.array(np.full(t.num_rows, kind, np.int8), pa.int8())
        return t.set_column(t.column_names.index(KIND_COL), KIND_COL, kinds)

    parts: List[pa.Table] = []
    if deletes.num_rows:
        parts.append(_with_kind(deletes, RowKind.DELETE))
    if inserts.num_rows:
        parts.append(_with_kind(inserts, RowKind.INSERT))
    if a_m.num_rows:
        ub = _with_kind(b_m, RowKind.UPDATE_BEFORE)
        ua = _with_kind(a_m, RowKind.UPDATE_AFTER)
        idx = np.arange(a_m.num_rows)
        pair = pa.concat_tables([ub, ua], promote_options="none")
        order = np.empty(2 * a_m.num_rows, dtype=np.int64)
        order[0::2] = idx                   # -U
        order[1::2] = idx + a_m.num_rows    # +U
        parts.append(pair.take(pa.array(order)))
    if not parts:
        return after.slice(0, 0)
    return pa.concat_tables(parts, promote_options="none")
