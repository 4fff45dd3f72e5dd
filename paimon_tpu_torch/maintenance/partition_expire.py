"""Partition expiration.

reference: operation/PartitionExpire.java + partition expiration
strategies (values-time: parse a timestamp out of the partition values
via partition.timestamp-formatter/pattern, drop partitions older than
partition.expiration-time).

A copy of paimon_tpu/maintenance/partition_expire.py (no JAX in it).
"""

from __future__ import annotations

import datetime as _dt
import time as _time
from typing import List, Optional, Tuple

from paimon_tpu_torch.core.commit import FileStoreCommit
from paimon_tpu_torch.manifest import FileKind, ManifestEntry
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.snapshot.snapshot import BATCH_COMMIT_IDENTIFIER

__all__ = ["expire_partitions", "partition_time_ms"]

_JAVA_TO_STRPTIME = [
    ("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
]


def _to_strptime(fmt: str) -> str:
    for java, py in _JAVA_TO_STRPTIME:
        fmt = fmt.replace(java, py)
    return fmt


def partition_time_ms(options, values: "dict") -> Optional[int]:
    """Partition time via partition.timestamp-formatter/pattern — the
    single timestamp-extraction used by expiry AND mark-done (reference
    partition/PartitionTimeExtractor.java). `values`: key -> value.
    None when the partition does not parse."""
    fmt = _to_strptime(options.get(
        CoreOptions.PARTITION_TIMESTAMP_FORMATTER) or "yyyy-MM-dd")
    pattern = options.get(CoreOptions.PARTITION_TIMESTAMP_PATTERN)
    if pattern:
        text = pattern
        for k, v in values.items():
            text = text.replace(f"${k}", str(v))
    else:
        if not values:
            return None
        text = str(next(iter(values.values())))
    try:
        ts = _dt.datetime.strptime(text, fmt)
    except ValueError:
        return None
    return int(ts.timestamp() * 1000)


def expire_partitions(table, expiration_ms: Optional[int] = None,
                      now_ms: Optional[int] = None,
                      dry_run: bool = False) -> List[Tuple]:
    """Drop partitions whose time value is older than the expiration
    window. Returns the expired partition tuples."""
    options = table.options
    if expiration_ms is None:
        expiration_ms = options.get(CoreOptions.PARTITION_EXPIRATION_TIME)
    if expiration_ms is None:
        raise ValueError("partition.expiration-time is not set")
    if not table.partition_keys:
        raise ValueError("table is not partitioned")
    now = now_ms if now_ms is not None else int(_time.time() * 1000)
    cutoff = now - expiration_ms

    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return []
    scan = table.new_scan()
    entries = scan.read_entries(snapshot)

    pkeys = table.partition_keys
    expired_parts = set()
    by_part = {}
    for e in entries:
        values = scan._partition_codec.from_bytes(e.partition)
        by_part.setdefault(e.partition, (values, []))[1].append(e)
    for pbytes, (values, _) in by_part.items():
        ms = partition_time_ms(options, dict(zip(pkeys, values)))
        if ms is None:
            continue        # unparseable partitions never expire
        if ms < cutoff:
            expired_parts.add((ms / 1000.0, pbytes))

    if not expired_parts:
        return []
    # cap the batch, oldest first (reference partition.expiration-max-num:
    # one call never drops more than this many partitions); keep the
    # sorted order so callers see a deterministic oldest-first list
    max_num = options.get(CoreOptions.PARTITION_EXPIRATION_MAX_NUM)
    expired_parts = [p for _, p in sorted(expired_parts)[:max_num]]
    out = [by_part[p][0] for p in expired_parts]
    if dry_run:
        return out

    delete_entries = []
    for pbytes in expired_parts:
        for e in by_part[pbytes][1]:
            delete_entries.append(ManifestEntry(
                FileKind.DELETE, e.partition, e.bucket, e.total_buckets,
                e.file))
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    commit._try_commit(delete_entries, [], BATCH_COMMIT_IDENTIFIER,
                       "OVERWRITE")
    return out
