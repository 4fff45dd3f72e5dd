"""Durable sweep watermarks for the incremental maintenance passes.

A clean fsck / orphan sweep is expensive to prove from scratch: the
full passes walk every retained snapshot's manifest graph.  Once a
sweep HAS come back clean, that work should not be repeated — the
verified prefix of the table is immutable, so the next sweep only
needs the delta.  This module gives the fsck and orphan planes one
shared way to persist "verified through here" as snapshot properties:

    <prefix>.snapshot   snapshot id the sweep verified through (the
                        tip at sweep time)
    <prefix>.base       that snapshot's base manifest-list name
    <prefix>.delta      that snapshot's delta manifest-list name
    <prefix>.ts         verification horizon in epoch ms — for fsck
                        the stamp wall-clock, for the orphan sweep
                        the grace CUTOFF below which every file on
                        storage was proven referenced-or-deleted

stamped on a small forced (empty) commit by the sweeping process, so
the watermark rides the snapshot chain like every other piece of
coordination state (leases, ownership generations, offsets) and needs
no side files.

Validation mirrors the plan cache's `matches_tip` guard
(core/plan_cache.py): `rollback_to` / `fast_forward` can delete and
REWRITE a snapshot id with different content, so a watermark is only
trusted when its snapshot still exists AND still names the same
base/delta manifest lists (list names embed a UUID — recreated ids
never collide).  An invalidated or expired watermark simply demotes
the next sweep to a full pass, which re-stamps at the new tip:
self-healing, never wrong.

A copy of paimon_tpu/maintenance/watermark.py (no JAX in it): either
package rides the other's watermark.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "FSCK_WATERMARK_PREFIX", "ORPHAN_WATERMARK_PREFIX",
    "SweepWatermark", "read_watermark", "validate_watermark",
    "stamp_watermark",
]

FSCK_WATERMARK_PREFIX = "maintenance.fsck.watermark"
ORPHAN_WATERMARK_PREFIX = "maintenance.orphan.watermark"


@dataclass(frozen=True)
class SweepWatermark:
    snapshot_id: int
    base_list: str
    delta_list: str
    ts_ms: int

    def to_properties(self, prefix: str) -> dict:
        return {
            f"{prefix}.snapshot": str(self.snapshot_id),
            f"{prefix}.base": self.base_list,
            f"{prefix}.delta": self.delta_list,
            f"{prefix}.ts": str(self.ts_ms),
        }

    @staticmethod
    def from_properties(prefix: str, props: dict
                        ) -> Optional["SweepWatermark"]:
        raw = props.get(f"{prefix}.snapshot")
        if raw is None:
            return None
        try:
            return SweepWatermark(
                snapshot_id=int(raw),
                base_list=props.get(f"{prefix}.base") or "",
                delta_list=props.get(f"{prefix}.delta") or "",
                ts_ms=int(props.get(f"{prefix}.ts") or 0))
        except ValueError:
            return None


def read_watermark(table, prefix: str,
                   max_walk: int = 64) -> Optional[SweepWatermark]:
    """Newest stamp wins: walk the chain newest-first (bounded — a
    stamp buried under more than `max_walk` foreign snapshots is
    treated as absent, demoting to a full pass that re-stamps at the
    tip)."""
    sm = table.snapshot_manager
    latest = sm.latest_snapshot_id()
    earliest = sm.earliest_snapshot_id()
    if latest is None or earliest is None:
        return None
    for sid in range(latest, max(earliest, latest - max_walk) - 1, -1):
        try:
            snap = sm.snapshot(sid)
        # lint-ok: fault-taxonomy id-walk skip, not a retry: an
        # expired/folded/corrupt id just moves the walk to the next
        except (FileNotFoundError, OSError, ValueError, KeyError):
            continue
        wm = SweepWatermark.from_properties(prefix,
                                            snap.properties or {})
        if wm is not None:
            return wm
    return None


def validate_watermark(table, wm: SweepWatermark) -> bool:
    """True iff the watermark's snapshot still exists with the SAME
    manifest lists — guards recreated ids after rollback_to /
    fast_forward exactly like the plan cache's `matches_tip`."""
    sm = table.snapshot_manager
    try:
        snap = sm.snapshot(wm.snapshot_id)
    except (FileNotFoundError, OSError, ValueError, KeyError):
        return False
    return ((snap.base_manifest_list or "") == wm.base_list
            and (snap.delta_manifest_list or "") == wm.delta_list)


def stamp_watermark(table, prefix: str, ts_ms: Optional[int] = None,
                    commit_user: str = "maintenance-sweep"
                    ) -> Optional[int]:
    """Record a clean sweep at the current tip via one small forced
    commit; returns the stamp snapshot's id (None when the table has
    no snapshots — nothing was verified, nothing to stamp)."""
    from paimon_tpu_torch.core.commit import FileStoreCommit

    snap = table.snapshot_manager.latest_snapshot()
    if snap is None:
        return None
    wm = SweepWatermark(
        snapshot_id=snap.id,
        base_list=snap.base_manifest_list or "",
        delta_list=snap.delta_manifest_list or "",
        ts_ms=int(_time.time() * 1000) if ts_ms is None else ts_ms)
    fc = FileStoreCommit(table.file_io, table.path, table.schema,
                         table.options, commit_user=commit_user,
                         branch=table.branch)
    return fc.commit([], properties=wm.to_properties(prefix),
                     force_create=True)
