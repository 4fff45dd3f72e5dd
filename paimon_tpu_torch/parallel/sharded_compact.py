"""Whole-table sharded bucket compaction over a mesh (deduplicate only).

Counterpart of paimon_tpu/parallel/sharded_compact.py, the legacy path
that parallel/mesh_engine.compact_table_mesh replaces for table-level
compaction:

  host:   decode each bucket's sorted runs and encode key lanes
  device: [B, N] bucket-stacked lanes; the batched segmented merge
          (one winner-select launch) and the commit statistics: each
          bucket's output rows (winners whose kind survives: +I, +U),
          and the winners and output rows summed over the mesh
  host:   take each bucket's winners, write its files, commit
          compact_before/compact_after in one COMPACT snapshot

reference: mergetree/compact/MergeTreeCompactTask.java:83 (one task per
bucket).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["ShardedCompactStats", "compact_table_sharded"]


class _ShardedCompactKernel:
    """Batched merge plus device-side statistics.

    __call__(lanes[B,N,L], seq_hi, seq_lo, invalid, kinds[B,N]) ->
    (perm[B,N], live[B,N], per_bucket_out[B], total_winners,
    total_out), the totals summed over the mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __call__(self, lanes, seq_hi, seq_lo, invalid, kinds):
        from paimon_tpu_torch.parallel.sharded_merge import (
            device_merge, pad_lanes,
        )

        mesh = self.mesh
        b, (lanes, seq_hi, seq_lo, invalid, kinds) = pad_lanes(
            mesh, lanes, seq_hi, seq_lo, invalid, kinds,
            fills=[0, 0, 0, 1, 0])
        perm, winner = device_merge(mesh, lanes, seq_hi, seq_lo, invalid,
                                    "last")
        # kinds travel in input order: gather them to sorted order so
        # the winner mask lines up (0 = +I, 2 = +U survive)
        s_kinds = torch.from_numpy(np.ascontiguousarray(
            mesh.local(kinds))).to(mesh.device).gather(-1, perm.long())
        live = winner & ((s_kinds == 0) | (s_kinds == 2))
        per_bucket = live.sum(dim=1, dtype=torch.int64)
        total_win = mesh.psum(winner.sum(dtype=torch.int64))
        total_live = mesh.psum(per_bucket.sum())
        perm, live, per_bucket = (mesh.gather(perm), mesh.gather(live),
                                  mesh.gather(per_bucket))
        return (perm.cpu().numpy()[:b], live.cpu().numpy()[:b],
                per_bucket.cpu().numpy()[:b], int(total_win),
                int(total_live))


class ShardedCompactStats:
    def __init__(self, buckets: int, input_rows: int, output_rows: int,
                 total_winners: int, snapshot_id: Optional[int]):
        self.buckets = buckets
        self.input_rows = input_rows
        self.output_rows = output_rows
        self.total_winners = total_winners
        self.snapshot_id = snapshot_id


def compact_table_sharded(table, mesh=None) -> ShardedCompactStats:
    """Full compaction of every bucket of a deduplicate primary-key table
    in one batched merge: read -> merge and statistics on the device ->
    write -> COMPACT commit.  The commit's row counts come from the
    device, held against the host's count of what it wrote."""
    import pyarrow as pa

    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.kv_file import read_kv_file
    from paimon_tpu_torch.core.read import assemble_runs, evolve_table
    from paimon_tpu_torch.core.write import CommitMessage
    from paimon_tpu_torch.ops.merge import KIND_COL, SEQ_COL
    from paimon_tpu_torch.options import MergeEngine
    from paimon_tpu_torch.parallel.mesh_engine import (
        UnsupportedMergeEngineError, _EngineContext, _single_process,
    )
    from paimon_tpu_torch.parallel.sharded_merge import (
        bucket_mesh, pad_bucket_batches,
    )

    # this path hard-codes the deduplicate winner select: any other
    # engine fails loudly instead of silently deduplicating
    engine = table.options.merge_engine
    if engine != MergeEngine.DEDUPLICATE:
        raise UnsupportedMergeEngineError(
            f"compact_table_sharded only implements merge-engine "
            f"'deduplicate', got {engine!r}; use "
            f"parallel.mesh_engine.compact_table_mesh, which dispatches "
            f"on the merge engine")
    if not table.primary_keys:
        raise ValueError("sharded compaction targets primary-key tables")
    if mesh is None:
        mesh = bucket_mesh(device=table.device)
    _single_process(mesh)
    plan = table.new_read_builder().new_scan().plan()
    splits = [s for s in plan.splits if len(s.data_files) > 0]
    if not splits:
        return ShardedCompactStats(0, 0, 0, 0, None)

    ctx = _EngineContext(table)
    lanes_list, seq_list, kinds_list, tables = [], [], [], []
    n_input = 0
    for s in splits:
        runs = [evolve_table(
                    read_kv_file(table.file_io, ctx.path_factory,
                                 s.partition, s.bucket, f,
                                 schema=table.schema,
                                 schema_manager=table.schema_manager,
                                 options=table.options, device=table.device),
                    f.schema_id, ctx.schema, ctx.schema_manager,
                    ctx.schema_cache, keep_sys_cols=True)
                for run_files in assemble_runs(s.data_files)
                for f in run_files]
        t = pa.concat_tables(runs, promote_options="none")
        lanes, _ = ctx.key_encoder.encode_table(t, ctx.key_cols)
        lanes_list.append(lanes)
        seq_list.append(np.asarray(t.column(SEQ_COL).combine_chunks()
                                   .cast(pa.int64())))
        kinds_list.append(np.asarray(t.column(KIND_COL).combine_chunks()
                                     .cast(pa.int8())))
        tables.append(t)
        n_input += t.num_rows

    lanes, seq_hi, seq_lo, invalid = pad_bucket_batches(lanes_list,
                                                        seq_list)
    kinds = np.zeros(invalid.shape, dtype=np.int8)
    for i, k in enumerate(kinds_list):
        kinds[i, :len(k)] = k
    perm, live, per_bucket, total_win, total_live = _ShardedCompactKernel(
        mesh)(lanes, seq_hi, seq_lo, invalid, kinds)

    messages = []
    out_rows = 0
    for i, s in enumerate(splits):
        indices = perm[i][np.flatnonzero(live[i])].astype(np.int64)
        merged = tables[i].take(pa.array(indices))
        if merged.num_rows != per_bucket[i]:
            raise AssertionError(f"bucket {s.bucket}: wrote "
                                 f"{merged.num_rows} rows, the device "
                                 f"counted {per_bucket[i]}")
        out_rows += merged.num_rows
        after = ctx.writer.write(s.partition, s.bucket, merged,
                                 level=ctx.max_level) \
            if merged.num_rows else []
        messages.append(CommitMessage(
            s.partition, s.bucket, s.total_buckets,
            compact_before=list(s.data_files), compact_after=after))
    if out_rows != total_live:
        raise AssertionError(f"wrote {out_rows} rows, the device counted "
                             f"{total_live}")

    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    sid = commit.commit(messages)
    return ShardedCompactStats(len(splits), n_input, out_rows, total_win,
                               sid)
