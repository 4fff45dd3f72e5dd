"""Table-level statistics (ANALYZE).

Counterpart of paimon_tpu/stats.py.

reference: paimon-core/.../stats/Statistics.java (mergedRecordCount,
mergedRecordSize, colStats: distinctCount/min/max/nullCount/avgLen/
maxLen), StatsFile/StatsFileHandler (JSON file under statistics/,
referenced by an ANALYZE snapshot's `statistics` field).
"""

from __future__ import annotations

import json
import uuid
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.compute as pc

__all__ = ["analyze_table", "read_statistics"]


def _col_stats(col: pa.ChunkedArray) -> Dict:
    out: Dict = {"nullCount": col.null_count}
    try:
        out["distinctCount"] = pc.count_distinct(col).as_py()
    except pa.ArrowNotImplementedError:
        pass
    try:
        mm = pc.min_max(col)
        mn, mx = mm["min"].as_py(), mm["max"].as_py()
        out["min"] = str(mn) if mn is not None else None
        out["max"] = str(mx) if mx is not None else None
    except pa.ArrowNotImplementedError:
        pass
    t = col.type
    if pa.types.is_string(t) or pa.types.is_large_string(t) or \
            pa.types.is_binary(t) or pa.types.is_large_binary(t):
        lens = pc.binary_length(col.combine_chunks())
        if col.null_count < len(col):
            out["avgLen"] = int(pc.mean(lens).as_py() or 0)
            out["maxLen"] = int(pc.max(lens).as_py() or 0)
    elif pa.types.is_primitive(t):
        out["avgLen"] = out["maxLen"] = t.bit_width // 8
    return out


def analyze_table(table, columns: Optional[List[str]] = None
                  ) -> Optional[int]:
    """Full-scan ANALYZE: compute table/column stats, write a statistics
    file and commit an ANALYZE snapshot referencing it. Returns the
    snapshot id (reference flink AnalyzeTableProcedure ->
    StatsFileHandler.writeStats)."""
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.snapshot import CommitKind
    from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return None
    # scan pinned to the captured snapshot: concurrent commits must not
    # skew the stats away from the recorded snapshotId
    rb = table.new_read_builder()
    plan = rb.new_scan().plan(snapshot_id=snapshot.id)
    data = rb.new_read().to_arrow(plan)
    names = columns or [f.name for f in table.schema.fields]
    unknown = [n for n in names if n not in data.column_names]
    if unknown:
        raise ValueError(f"Unknown columns for ANALYZE: {unknown}")
    col_stats = {name: _col_stats(data.column(name)) for name in names}
    stats = {
        "snapshotId": snapshot.id,
        "schemaId": table.schema.id,
        "mergedRecordCount": data.num_rows,
        "mergedRecordSize": data.nbytes,
        "colStats": col_stats,
    }
    name = f"stats-{uuid.uuid4()}-0"
    table.file_io.write_bytes(
        f"{table.path}/statistics/{name}",
        json.dumps(stats, indent=2).encode("utf-8"), overwrite=False)

    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit._try_commit([], [], BATCH_COMMIT_IDENTIFIER,
                              CommitKind.ANALYZE, statistics=name)


def read_statistics(table) -> Optional[Dict]:
    """Latest statistics visible from the current snapshot chain
    (reference StatsFileHandler.readStats: walk back to the ANALYZE
    snapshot)."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    earliest = sm.earliest_snapshot_id()
    if latest is None:
        return None
    for sid in range(latest, (earliest or 1) - 1, -1):
        try:
            snap = sm.snapshot(sid)
        except FileNotFoundError:
            break
        if snap.statistics:
            raw = table.file_io.read_bytes(
                f"{table.path}/statistics/{snap.statistics}")
            return json.loads(raw)
    return None
