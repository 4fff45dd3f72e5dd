"""Warm boot: persist serving state through the shared SSD tier so a
new replica's first lookup is served from recovered state with ZERO
rebuild.

Counterpart of paimon_tpu/service/warmboot.py; the layout below is the
reference's, so either package restores state the other persisted.

The host-SSD collaborative-LSM design (PAPERS.md, arXiv 2410.21760)
pushes LSM serving state down to a shared SSD tier; the paimon-tpu
analog persists the two things a replica otherwise rebuilds per
process:

* the BUILT SST FILES of the point-lookup engine (lookup/sst.py),
  hard-linked under their STABLE store keys — `file|...` keys embed
  the immutable data-file name, `bucket|...` keys the bucket's file
  list digest, so any process over the same table computes the same
  keys and can adopt the files sight unseen (a key that stopped being
  live is reconciled away by the next plan load);
* the PLAN-CACHE live-entry state (core/plan_cache.py), serialized as
  a real avro container of manifest entries plus a JSON header — the
  restored replica's first plan is a delta-apply (or a pure cache
  hit), never a cold manifest walk.

Layout under `<service.warmboot.dir | cache.disk.dir/warmboot>/
<table digest>/`:

    manifest.json     {"snapshot_id", "ssts": {store_key: file},
                       "plan": {...} | null}   — published ATOMICALLY
                      last, so a reader never sees files without it
    plan.avro         live manifest entries (MANIFEST_ENTRY_AVRO_SCHEMA)
    <sha1(key)>.sst   the SST files themselves

The directory carries the same sharing contract as `cache.disk.dir`:
an SSD mount reachable by every machine's replicas.  Persisting is
idempotent (stable names, last writer wins) and restoring is advisory
— a vanished file or stale snapshot degrades to the normal cold path,
never to an error.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

__all__ = ["warmboot_dir", "table_state_dir", "persist_serving_state",
           "restore_serving_state"]

_MANIFEST = "manifest.json"
_PLAN = "plan.avro"


def warmboot_dir(options) -> Optional[str]:
    """The configured warm-boot root: `service.warmboot.dir`, else
    `<cache.disk.dir>/warmboot`, else None (warm boot unavailable)."""
    from paimon_tpu_torch.options import CoreOptions
    d = options.get(CoreOptions.SERVICE_WARMBOOT_DIR)
    if d:
        return d
    disk = options.get(CoreOptions.CACHE_DISK_DIR)
    if disk:
        return os.path.join(disk, "warmboot")
    return None


def table_state_dir(base: str, table) -> str:
    """Per-(table, branch) subdirectory — replicas of different tables
    share one warm-boot root without colliding."""
    digest = hashlib.sha1(
        f"{table.path.rstrip('/')}|{table.branch or 'main'}"
        .encode()).hexdigest()[:16]
    return os.path.join(base, digest)


def _link_or_copy(src: str, dst: str):
    tmp = dst + f".tmp-{os.getpid()}"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def persist_serving_state(query, dest: str) -> dict:
    """Persist `query`'s warm serving state into `dest`: every built
    SST hard-links (or copies across filesystems) under its stable
    store key, and the table's plan-cache state serializes as an avro
    entry container.  The manifest publishes last by atomic rename —
    a concurrent restore sees either the previous complete state or
    this one."""
    os.makedirs(dest, exist_ok=True)
    store = query.store
    ssts = {}
    for key in store.keys():
        reader = store.get(key)
        if reader is None:
            continue
        fname = hashlib.sha1(key.encode()).hexdigest()[:24] + ".sst"
        try:
            _link_or_copy(reader.path, os.path.join(dest, fname))
        except OSError:
            continue          # evicted under us: skip, stay advisory
        ssts[key] = fname
    plan_meta = None
    from paimon_tpu_torch.core.plan_cache import shared_plan_cache
    state = shared_plan_cache(query.table.path,
                              query.table.branch).state()
    if state is not None:
        from paimon_tpu_torch.format import avro as avro_fmt
        from paimon_tpu_torch.manifest.manifest_entry import (
            MANIFEST_ENTRY_AVRO_SCHEMA,
        )
        entries = [e for d in state.groups.values()
                   for e in d.values()]
        data = avro_fmt.write_container(
            MANIFEST_ENTRY_AVRO_SCHEMA,
            [e.to_avro() for e in entries])
        tmp = os.path.join(dest, _PLAN + f".tmp-{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(dest, _PLAN))
        plan_meta = {"snapshot_id": state.snapshot_id,
                     "base_list": state.base_list,
                     "delta_list": state.delta_list,
                     "index_manifest": state.index_manifest,
                     "entry_count": state.entry_count}
    manifest = {"snapshot_id": query.snapshot_id, "ssts": ssts,
                "plan": plan_meta}
    tmp = os.path.join(dest, _MANIFEST + f".tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(dest, _MANIFEST))
    return {"ssts": len(ssts), "snapshot_id": query.snapshot_id,
            "plan": plan_meta is not None}


def restore_serving_state(query, src: str) -> dict:
    """Adopt persisted state into `query` BEFORE its first lookup: the
    plan-cache state republishes (so the first plan is a cache hit or
    delta-apply instead of a cold walk) and every persisted SST is
    adopted under its store key with no reader build.  Advisory end to
    end: missing/corrupt state restores nothing and the cold path
    runs; state for keys no longer live is reconciled away by the
    first plan load."""
    out = {"ssts": 0, "plan": False}
    try:
        with open(os.path.join(src, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return out
    if manifest.get("plan"):
        try:
            from paimon_tpu_torch.core.plan_cache import (
                PlanState, shared_plan_cache,
            )
            from paimon_tpu_torch.format import avro as avro_fmt
            from paimon_tpu_torch.manifest.manifest_entry import ManifestEntry
            with open(os.path.join(src, _PLAN), "rb") as f:
                _, records = avro_fmt.read_container(f.read())
            groups: dict = {}
            for r in records:
                e = ManifestEntry.from_avro(r)
                groups.setdefault((e.partition, e.bucket),
                                  {})[e.identifier()] = e
            pm = manifest["plan"]
            state = PlanState(pm["snapshot_id"], pm["base_list"],
                              pm["delta_list"], pm["index_manifest"],
                              groups,
                              sum(len(d) for d in groups.values()))
            cache = shared_plan_cache(query.table.path,
                                      query.table.branch)
            cache.put_state(state, cache.state())
            out["plan"] = True
        except (OSError, ValueError, KeyError):
            pass          # stale/corrupt plan blob: cold plan instead
    for key, fname in (manifest.get("ssts") or {}).items():
        path = os.path.join(src, fname)
        if not os.path.exists(path):
            continue
        try:
            query.store.adopt(key, path)
            out["ssts"] += 1
        except (OSError, ValueError, RuntimeError):
            continue      # unreadable file: build it cold instead
    return out
