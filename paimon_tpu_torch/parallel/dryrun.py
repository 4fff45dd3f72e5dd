"""Mesh dryrun: write -> mesh compaction -> all_to_all bucket rescale.

Counterpart of paimon_tpu/parallel/dryrun.py, on this package's mesh
(parallel/sharded_merge.bucket_mesh: bucket lanes merged as one batch
on one torch device).  A multi-bucket primary-key table is written
through the normal write and commit path, then

1. `compact_table_mesh` (parallel/mesh_engine.py) runs every bucket's
   full compaction in one streamed mesh program and commits the
   COMPACT snapshot;
2. `rescale_table_buckets` re-routes every row to twice the buckets
   with the all_to_all dispatch and commits the overwrite;
3. the read-back after both is checked against the merge-on-read state
   before them.

`run_engines` is the mesh benchmark: deduplicate and aggregation full
compactions through the mesh engine at >= `rows` input rows each.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import pyarrow as pa

__all__ = ["run", "run_engines", "engine_table", "input_rows"]


def _schema(n_buckets: int, extra: Optional[dict] = None):
    from paimon_tpu_torch.schema import Schema
    from paimon_tpu_torch.types import BigIntType, DoubleType

    return (Schema.builder()
            .column("id", BigIntType(False))
            .column("v", DoubleType())
            .primary_key("id")
            .options({"bucket": str(n_buckets), "write-only": "true",
                      **(extra or {})})
            .build())


def _commit_ids(table, rng, rows: int, key_space: int):
    """Commit `rows` ids uniform in [0, key_space) with random v;
    returns (ids, v)."""
    wb = table.new_batch_write_builder()
    ids = rng.integers(0, key_space, rows)
    vals = rng.random(len(ids))
    with wb.new_write() as w:
        w.write_arrow(pa.table({
            "id": pa.array(ids, pa.int64()),
            "v": pa.array(vals, pa.float64())}))
        wb.new_commit().commit(w.prepare_commit())
    return ids, vals


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def input_rows(table) -> int:
    """Rows in the data files of the latest snapshot: what a full
    compaction reads."""
    return sum(f.row_count for s in
               table.new_read_builder().new_scan().plan().splits
               for f in s.data_files)


def engine_table(path: str, engine: str, n_buckets: int, rows: int,
                 device=None):
    """run_engines' table at `path` for merge engine `engine`
    (aggregation sums v): commits of rows/2 ids uniform in [0, rows)
    from seed 6, at least two (two overlapping L0 runs per bucket),
    then more until >= `rows` rows reach the compaction, since the
    write path's flush pre-merges duplicate keys.  Returns (table, ids,
    v) of every row written, in write order."""
    from paimon_tpu_torch.table import FileStoreTable

    extra = {"merge-engine": engine}
    if engine == "aggregation":
        extra["fields.v.aggregate-function"] = "sum"
    table = FileStoreTable.create(path, _schema(n_buckets, extra),
                                  device=device)
    rng = np.random.default_rng(6)
    ids, vals = [], []
    while len(ids) < 2 or input_rows(table) < rows:
        i, v = _commit_ids(table, rng, rows // 2, rows)
        ids.append(i)
        vals.append(v)
    return table, np.concatenate(ids), np.concatenate(vals)


def run(n_lanes: int, device=None, total_rows: Optional[int] = None) -> None:
    """The dryrun on `n_lanes` lanes on `device` (None: cuda), at
    DRYRUN_ROWS rows (default 1,300,000: the write path's flush
    pre-merges duplicate keys, so >= 1M rows reach the compaction)."""
    from paimon_tpu_torch.parallel import (
        bucket_mesh, compact_table_mesh, rescale_table_buckets,
    )
    from paimon_tpu_torch.table import FileStoreTable

    n_buckets = n_lanes
    if total_rows is None:
        total_rows = int(os.environ.get("DRYRUN_ROWS", "1300000"))
    with tempfile.TemporaryDirectory() as tmp:
        table = FileStoreTable.create(os.path.join(tmp, "t"),
                                      _schema(n_buckets), device=device)
        rng = np.random.default_rng(0)
        # two commits: two overlapping L0 runs per bucket
        for _ in range(2):
            _commit_ids(table, rng, total_rows // 2, total_rows)
        expected = table.to_arrow().num_rows   # merge-on-read truth
        n_input = input_rows(table)

        mesh = bucket_mesh(n_lanes, device=table.device)
        stats = compact_table_mesh(table, mesh)
        _check(stats.snapshot_id is not None
               and table.latest_snapshot().commit_kind == "COMPACT",
               "the mesh compaction committed no COMPACT snapshot")
        _check(stats.buckets == n_buckets,
               f"{stats.buckets} buckets compacted of {n_buckets}")
        _check(stats.output_rows == expected,
               f"{stats.output_rows} output rows, {expected} expected")

        sid = rescale_table_buckets(table, 2 * n_buckets, mesh=mesh)
        table2 = FileStoreTable.load(table.path, device=table.device)
        _check(sid is not None and table2.options.bucket == 2 * n_buckets,
               f"rescale: snapshot {sid}, bucket {table2.options.bucket}")
        after = table2.to_arrow().num_rows
        _check(after == expected,
               f"{after} rows after the rescale, {expected} expected")
        print(f"dryrun OK: {n_lanes} lanes on {mesh.device}, "
              f"{n_buckets}->{2 * n_buckets} buckets, {n_input} input "
              f"rows -> {expected} merged rows (mesh compaction + "
              f"all_to_all rescale)")


def run_engines(n_lanes: int = 8, rows: int = 10_000_000, mesh=None,
                out_path: Optional[str] = None, device=None) -> dict:
    """Mesh benchmark: deduplicate and aggregation (v sum) full
    compactions at >= `rows` input rows each, `n_lanes` buckets on
    `n_lanes` lanes.  Returns (and optionally writes as JSON) each
    engine's rows/s and the engine's window and packing counters."""
    from paimon_tpu_torch.parallel import bucket_mesh, compact_table_mesh

    if mesh is None:
        mesh = bucket_mesh(n_lanes, device=device)
    n_lanes = mesh.n_lanes
    record = {"lanes": n_lanes, "device": str(mesh.device),
              "requested_rows": rows, "engines": {}}
    for engine in ("deduplicate", "aggregation"):
        with tempfile.TemporaryDirectory() as tmp:
            table, _, _ = engine_table(os.path.join(tmp, engine), engine,
                                       n_lanes, rows, mesh.device)
            t0 = time.perf_counter()
            stats = compact_table_mesh(table, mesh)
            dt = time.perf_counter() - t0
            after = table.to_arrow().num_rows
            _check(stats.snapshot_id is not None
                   and stats.output_rows == after,
                   f"{engine}: snapshot {stats.snapshot_id}, "
                   f"{stats.output_rows} output rows, {after} read")
            record["engines"][engine] = {
                "input_rows": stats.input_rows,
                "output_rows": stats.output_rows,
                "buckets": stats.buckets, "windows": stats.windows,
                "peak_window_rows": stats.peak_window_rows,
                "peak_buffered_rows": stats.peak_buffered_rows,
                "packing_skew": stats.skew, "seconds": dt,
                "rows_per_sec": stats.input_rows / dt}
            print(f"run_engines {engine}: {stats.input_rows} rows in "
                  f"{dt:.2f}s = {stats.input_rows / dt:,.0f} rows/s "
                  f"({stats.windows} windows, skew {stats.skew:.2f})")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
            f.write("\n")
    return record
