"""Table fsck: verify the snapshot → manifest → file graph.

After a crash (torn maintenance job, out-of-band deletion, a buggy
tool) nothing in the store verifies that a table's metadata graph still
holds together; every reader just fails at whatever broken edge it hits
first.  `fsck(table)` walks the whole graph — snapshot chain + hints,
base/delta/changelog manifest lists, manifest files, data files,
index/DV manifests — and reports TYPED violations so operators (and the
crash-point sweep tests) can tell corruption classes apart:

    structure   snapshot-gap, bad-hint, corrupt-snapshot
    metadata    missing-manifest-list, corrupt-manifest-list,
                missing-manifest, corrupt-manifest
    data        dangling-data-file, file-size-mismatch,
                corrupt-data-file (deep), stats-mismatch (deep)
    invariants  level-overlap, row-count-mismatch
    index       missing-index-manifest, corrupt-index-manifest,
                dangling-index-file
    changelog   dangling-changelog-file
    multihost   ownership-inconsistency (the multihost.ownership.*
                properties the sharded write/maintenance planes stamp
                must be internally consistent along the chain: a
                version that regresses, one version denoting two
                different (processes, buckets, dead) maps, or a dead
                set that shrinks within one topology means a botched
                takeover — diagnosable offline, not fixable)

Manifest kinds are split by object class on purpose: `fix_violations`
drops + rewrites DATA manifests (missing-manifest/corrupt-manifest),
which would be flat wrong for an index manifest or a snapshot file —
those get their own kinds and are not fixable.

`maintenance/repair.py::fix_violations` maps fixable classes onto the
existing repair actions (remove_unexisting_files /
remove_unexisting_manifests / compact_manifests) — the CLI surface is
`paimon table fsck db.t [--deep] [--fix]`.

Counterpart of paimon_tpu/maintenance/fsck.py: the same walk, kinds and
reports.  The ownership stamps are parsed by this module's own copy of
the reference's `parallel/distributed.py` `stamp_from_properties`
(the current generation only; fsck reads nothing else of a stamp).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from paimon_tpu_torch.manifest import FileKind, merge_manifest_entries
from paimon_tpu_torch.snapshot import Snapshot
from paimon_tpu_torch.snapshot.snapshot_manager import (
    EARLIEST, LATEST, SNAPSHOT_PREFIX,
)

__all__ = ["ViolationKind", "FsckViolation", "FsckReport", "fsck",
           "OwnershipStamp", "stamp_from_properties"]

# the multi-host planes' ownership stamp (reference
# paimon_tpu/parallel/distributed.py:94-97)
OWNERSHIP_VERSION_PROP = "multihost.ownership.version"
OWNERSHIP_PROCESSES_PROP = "multihost.ownership.processes"
OWNERSHIP_BUCKETS_PROP = "multihost.ownership.buckets"
OWNERSHIP_DEAD_PROP = "multihost.ownership.dead"


@dataclass(frozen=True)
class OwnershipStamp:
    """One generation of the sharded write-ownership map, as a snapshot
    records it (reference distributed.OwnershipMap)."""
    version: int
    num_processes: int
    num_buckets: int
    dead: frozenset = frozenset()


def stamp_from_properties(props: Dict[str, str]
                          ) -> Optional[OwnershipStamp]:
    """The current ownership generation recorded in one snapshot's
    properties, or None when the snapshot is unstamped; ValueError
    when the stamp does not parse (reference
    distributed.stamp_from_properties and _map_from_properties)."""
    if OWNERSHIP_VERSION_PROP not in (props or {}):
        return None
    dead = frozenset(
        int(p) for p in (props.get(OWNERSHIP_DEAD_PROP) or "").split(",")
        if p.strip())
    return OwnershipStamp(
        int(props[OWNERSHIP_VERSION_PROP]),
        int(props.get(OWNERSHIP_PROCESSES_PROP) or 0),
        int(props.get(OWNERSHIP_BUCKETS_PROP) or 0), dead)


class ViolationKind:
    SNAPSHOT_GAP = "snapshot-gap"
    BAD_HINT = "bad-hint"
    CORRUPT_SNAPSHOT = "corrupt-snapshot"
    MISSING_MANIFEST_LIST = "missing-manifest-list"
    CORRUPT_MANIFEST_LIST = "corrupt-manifest-list"
    MISSING_MANIFEST = "missing-manifest"
    CORRUPT_MANIFEST = "corrupt-manifest"
    MISSING_INDEX_MANIFEST = "missing-index-manifest"
    CORRUPT_INDEX_MANIFEST = "corrupt-index-manifest"
    DANGLING_DATA_FILE = "dangling-data-file"
    FILE_SIZE_MISMATCH = "file-size-mismatch"
    CORRUPT_DATA_FILE = "corrupt-data-file"
    STATS_MISMATCH = "stats-mismatch"
    LEVEL_OVERLAP = "level-overlap"
    ROW_COUNT_MISMATCH = "row-count-mismatch"
    DANGLING_INDEX_FILE = "dangling-index-file"
    DANGLING_CHANGELOG_FILE = "dangling-changelog-file"
    OWNERSHIP_INCONSISTENCY = "ownership-inconsistency"

    # classes fix_violations can repair ON THE LATEST SNAPSHOT (older
    # snapshots heal by expiring); the rest only heal by restore/expiry
    FIXABLE = frozenset({
        BAD_HINT, MISSING_MANIFEST, CORRUPT_MANIFEST,
        DANGLING_DATA_FILE, ROW_COUNT_MISMATCH,
    })


@dataclass
class FsckViolation:
    kind: str
    obj: str                       # the offending file/hint/bucket
    detail: str
    snapshot_id: Optional[int] = None

    def to_dict(self) -> dict:
        return {"kind": self.kind, "object": self.obj,
                "detail": self.detail, "snapshot": self.snapshot_id}


@dataclass
class FsckReport:
    violations: List[FsckViolation] = field(default_factory=list)
    snapshots_checked: int = 0
    manifests_checked: int = 0
    data_files_checked: int = 0
    # total manifest ENTRIES decoded — the incremental-vs-full tests
    # assert O(delta) work on this, not on wall clock
    manifest_entries_decoded: int = 0
    # whether this run actually rode a valid watermark (False when
    # incremental was requested but absent/invalidated -> full pass)
    incremental: bool = False

    @property
    def ok(self) -> bool:
        return not self.violations

    def kinds(self) -> Set[str]:
        return {v.kind for v in self.violations}

    def by_kind(self, kind: str) -> List[FsckViolation]:
        return [v for v in self.violations if v.kind == kind]

    def add(self, kind: str, obj: str, detail: str,
            snapshot_id: Optional[int] = None):
        self.violations.append(
            FsckViolation(kind, obj, detail, snapshot_id))

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "snapshots_checked": self.snapshots_checked,
            "manifests_checked": self.manifests_checked,
            "data_files_checked": self.data_files_checked,
            "manifest_entries_decoded": self.manifest_entries_decoded,
            "incremental": self.incremental,
            "violations": [v.to_dict() for v in self.violations],
        }


class _GraphWalker:
    """Shared caches across snapshots: a manifest read/verified once is
    not re-read for every snapshot referencing it."""

    def __init__(self, table, report: FsckReport, deep: bool):
        self.table = table
        self.scan = table.new_scan()
        self.report = report
        self.deep = deep
        # name -> entries, or None when the manifest is missing/corrupt
        self._manifest_cache: Dict[str, Optional[list]] = {}
        self._exists_cache: Dict[str, bool] = {}
        # manifests proven by the LAST clean sweep (seeded from the
        # watermark snapshot) or earlier in THIS run — the incremental
        # walk never re-decodes them (manifest files are immutable)
        self._verified: set = set()
        self._verified_index: set = set()
        key_types = [
            table.schema.logical_row_type().get_field(k).type.copy(False)
            for k in table.schema.trimmed_primary_keys()]
        self._key_codec = None
        if key_types:
            from paimon_tpu_torch.data.binary_row import BinaryRowCodec
            self._key_codec = BinaryRowCodec(key_types)

    # -- primitives ----------------------------------------------------------

    def _exists(self, path: str) -> bool:
        cached = self._exists_cache.get(path)
        if cached is None:
            cached = self._exists_cache[path] = \
                self.table.file_io.exists(path)
        return cached

    def _decode_key(self, b: bytes):
        if not b or self._key_codec is None:
            return None
        try:
            return tuple(self._key_codec.from_bytes(b))
        except Exception:                   # noqa: BLE001
            return None                     # undecodable -> skip overlap

    def read_manifest(self, name: str, sid: Optional[int]
                      ) -> Optional[list]:
        if name in self._manifest_cache:
            return self._manifest_cache[name]
        path = self.scan.manifest_file.path(name)
        entries: Optional[list] = None
        if not self._exists(path):
            self.report.add(ViolationKind.MISSING_MANIFEST, name,
                            "manifest file referenced by the manifest "
                            "list does not exist on storage", sid)
        else:
            try:
                entries = self.scan.manifest_file.read(name)
            except Exception as e:          # noqa: BLE001
                self.report.add(
                    ViolationKind.CORRUPT_MANIFEST, name,
                    f"manifest file exists but cannot be decoded "
                    f"(truncated or corrupt): {e}", sid)
        self.report.manifests_checked += 1
        if entries is not None:
            self.report.manifest_entries_decoded += len(entries)
        self._manifest_cache[name] = entries
        return entries

    def read_manifest_list(self, name: str, sid: Optional[int],
                           plane: str) -> Optional[list]:
        path = self.scan.manifest_list.path(name)
        if not self._exists(path):
            self.report.add(ViolationKind.MISSING_MANIFEST_LIST, name,
                            f"{plane} manifest list missing", sid)
            return None
        try:
            return self.scan.manifest_list.read(name)
        except Exception as e:              # noqa: BLE001
            self.report.add(ViolationKind.CORRUPT_MANIFEST_LIST, name,
                            f"{plane} manifest list undecodable: {e}",
                            sid)
            return None

    def data_file_path(self, entry) -> str:
        partition = self.scan._partition_codec.from_bytes(
            entry.partition)
        return entry.file.external_path or \
            self.scan.path_factory.data_file_path(
                partition, entry.bucket, entry.file.file_name)

    # -- per-snapshot checks -------------------------------------------------

    def check_snapshot(self, snap: Snapshot):
        report, sid = self.report, snap.id
        report.snapshots_checked += 1
        entries: list = []
        for plane, list_name in (("base", snap.base_manifest_list),
                                 ("delta", snap.delta_manifest_list)):
            if not list_name:
                continue
            metas = self.read_manifest_list(list_name, sid, plane)
            for m in metas or []:
                got = self.read_manifest(m.file_name, sid)
                if got is not None:
                    entries.extend(got)
        live = [e for e in merge_manifest_entries(entries)
                if e.kind == FileKind.ADD]
        self._check_data_files(live, sid)
        self._check_level_overlap(live, sid)
        self._check_row_counts(live, snap)
        self._check_index_manifest(snap)
        self._check_changelogs(snap)

    # -- incremental walk (rides the delta manifest lists) -------------------

    def seed_from(self, snap: Snapshot) -> bool:
        """Mark every manifest reachable from the watermark snapshot as
        verified (names only — two list reads, zero manifest decodes).
        False when a list is unreadable: the watermark can't be
        trusted and the caller demotes to a full pass."""
        for list_name in (snap.base_manifest_list,
                          snap.delta_manifest_list):
            if not list_name:
                continue
            try:
                metas = self.scan.manifest_list.read(list_name)
            except Exception:               # noqa: BLE001
                return False
            self._verified.update(m.file_name for m in metas)
        if snap.index_manifest:
            self._verified_index.add(snap.index_manifest)
        return True

    def check_snapshot_delta(self, snap: Snapshot,
                             prev: Optional[Snapshot]):
        """Incremental per-snapshot check: decode only manifests NOT
        proven by the last clean sweep (new delta manifests, base
        manifests rewritten by manifest compaction) and verify the
        data files they ADD.  The level-overlap and absolute
        row-count invariants need the MERGED live set and stay with
        the periodic full pass (the oracle); the absolute count is
        replaced here by the arithmetic delta check — each snapshot's
        totalRecordCount must equal the previous one's plus the net
        row count of its delta manifests, anchored at the watermark
        snapshot's verified total."""
        report, sid = self.report, snap.id
        report.snapshots_checked += 1
        new_entries: list = []
        delta_rows = 0
        for plane, list_name in (("base", snap.base_manifest_list),
                                 ("delta", snap.delta_manifest_list)):
            if not list_name:
                continue
            metas = self.read_manifest_list(list_name, sid, plane)
            for m in metas or []:
                if m.file_name in self._verified:
                    continue
                self._verified.add(m.file_name)
                got = self.read_manifest(m.file_name, sid)
                for e in got or []:
                    new_entries.append(e)
                    if plane == "delta":
                        delta_rows += e.file.row_count \
                            if e.kind == FileKind.ADD \
                            else -e.file.row_count
        live = [e for e in new_entries if e.kind == FileKind.ADD]
        self._check_data_files(live, sid)
        if prev is not None:
            want = prev.total_record_count + delta_rows
            if want != snap.total_record_count:
                report.add(
                    ViolationKind.ROW_COUNT_MISMATCH,
                    f"{SNAPSHOT_PREFIX}{sid}",
                    f"snapshot records totalRecordCount="
                    f"{snap.total_record_count}, previous snapshot "
                    f"{prev.id} plus its delta manifests gives "
                    f"{want}", sid)
        if snap.index_manifest and \
                snap.index_manifest not in self._verified_index:
            self._verified_index.add(snap.index_manifest)
            self._check_index_manifest(snap)
        self._check_changelogs(snap)

    def _check_data_files(self, live, sid: int):
        report = self.report
        for e in live:
            report.data_files_checked += 1
            path = self.data_file_path(e)
            if not self._exists(path):
                report.add(ViolationKind.DANGLING_DATA_FILE,
                           e.file.file_name,
                           f"data file referenced by bucket "
                           f"{e.bucket} is missing: {path}", sid)
                continue
            if e.file.file_size:
                try:
                    actual = self.table.file_io.get_file_size(path)
                except OSError:
                    actual = None
                if actual is not None and actual != e.file.file_size:
                    report.add(
                        ViolationKind.FILE_SIZE_MISMATCH,
                        e.file.file_name,
                        f"manifest records {e.file.file_size} bytes, "
                        f"storage holds {actual}", sid)
            partition = self.scan._partition_codec.from_bytes(
                e.partition)
            for extra in e.file.extra_files:
                epath = self.scan.path_factory.data_file_path(
                    partition, e.bucket, extra)
                if not self._exists(epath):
                    report.add(ViolationKind.DANGLING_DATA_FILE, extra,
                               f"extra file of {e.file.file_name} "
                               f"missing: {epath}", sid)
            if self.deep:
                self._deep_check_file(e, path, sid)

    def _deep_check_file(self, e, path: str, sid: int):
        """Read the file and compare actual row count against the
        manifest meta (stats plane)."""
        from paimon_tpu_torch.format import get_format
        from paimon_tpu_torch.fs.caching import footer_cache_disabled
        try:
            ext = e.file.file_name.rsplit(".", 1)[-1]
            fmt = get_format(ext)
            rows = 0
            # verification must reparse the ON-DISK footer — a warm
            # process-wide footer cache would mask footer corruption
            with footer_cache_disabled():
                for batch in fmt.create_reader().read_batches(
                        self.table.file_io, path):
                    rows += batch.num_rows
        except Exception as exc:            # noqa: BLE001
            self.report.add(ViolationKind.CORRUPT_DATA_FILE,
                            e.file.file_name,
                            f"data file unreadable: {exc}", sid)
            return
        if rows != e.file.row_count:
            self.report.add(
                ViolationKind.STATS_MISMATCH, e.file.file_name,
                f"manifest stats record {e.file.row_count} rows, file "
                f"holds {rows}", sid)

    def _check_level_overlap(self, live, sid: int):
        """Sorted runs at level >= 1 must not overlap in key range
        within one (partition, bucket, level) — the invariant
        ConflictDetection guards at commit time, re-checked at rest."""
        if self._key_codec is None:
            return
        groups: Dict[Tuple, list] = {}
        for e in live:
            if e.file.level and e.file.level > 0:
                groups.setdefault(
                    (e.partition, e.bucket, e.file.level), []).append(e)
        for (_, bucket, level), es in groups.items():
            ranged = []
            for e in es:
                lo = self._decode_key(e.file.min_key)
                hi = self._decode_key(e.file.max_key)
                if lo is not None and hi is not None:
                    ranged.append((lo, hi, e.file.file_name))
            ranged.sort()
            for (lo1, hi1, n1), (lo2, hi2, n2) in zip(ranged,
                                                      ranged[1:]):
                if lo2 <= hi1:
                    self.report.add(
                        ViolationKind.LEVEL_OVERLAP, n2,
                        f"bucket {bucket} level {level}: key range of "
                        f"{n2} overlaps {n1} "
                        f"([{lo1}..{hi1}] vs [{lo2}..{hi2}])", sid)

    def _check_row_counts(self, live, snap: Snapshot):
        total = sum(e.file.row_count for e in live)
        if total != snap.total_record_count:
            self.report.add(
                ViolationKind.ROW_COUNT_MISMATCH,
                f"{SNAPSHOT_PREFIX}{snap.id}",
                f"snapshot records totalRecordCount="
                f"{snap.total_record_count}, live manifest entries sum "
                f"to {total}", snap.id)

    def _check_index_manifest(self, snap: Snapshot):
        if not snap.index_manifest:
            return
        report, sid = self.report, snap.id
        path = self.scan.index_manifest_file.path(snap.index_manifest)
        if not self._exists(path):
            report.add(ViolationKind.MISSING_INDEX_MANIFEST,
                       snap.index_manifest,
                       "index manifest missing", sid)
            return
        try:
            ientries = self.scan.index_manifest_file.read(
                snap.index_manifest)
        except Exception as e:              # noqa: BLE001
            report.add(ViolationKind.CORRUPT_INDEX_MANIFEST,
                       snap.index_manifest,
                       f"index manifest undecodable: {e}", sid)
            return
        for ie in ientries:
            if ie.kind != FileKind.ADD:
                continue
            ipath = self.scan.path_factory.index_file_path(
                ie.index_file.file_name)
            if not self._exists(ipath):
                report.add(ViolationKind.DANGLING_INDEX_FILE,
                           ie.index_file.file_name,
                           f"index/DV file missing: {ipath}", sid)

    def _check_changelogs(self, snap: Snapshot):
        if not snap.changelog_manifest_list:
            return
        sid = snap.id
        metas = self.read_manifest_list(snap.changelog_manifest_list,
                                        sid, "changelog")
        for m in metas or []:
            entries = self.read_manifest(m.file_name, sid)
            for e in entries or []:
                if e.kind != FileKind.ADD:
                    continue
                path = self.data_file_path(e)
                if not self._exists(path):
                    self.report.add(
                        ViolationKind.DANGLING_CHANGELOG_FILE,
                        e.file.file_name,
                        f"changelog file missing: {path}", sid)


def _check_ownership_chain(table, report: FsckReport, ids: List[int]):
    """Multi-host ownership stamps (parallel/distributed.py +
    parallel/maintenance_plane.py) must be internally consistent along
    the snapshot chain:

    1. `multihost.ownership.version` never regresses — a takeover, a
       rescale and a topology change each BUMP it, so a later snapshot
       stamped with an older version means two planes disagreed about
       the current generation (split-brain) or a botched takeover
       resumed a stale map;
    2. one version denotes exactly one map: every snapshot stamping
       version V must record the same (processes, buckets, dead) —
       a stamped process count disagreeing with the recorded bucket
       map is the signature of a restart that reused a version for a
       different topology.

    (A new generation MAY clear the dead set — a full-cohort rejoin
    bumps the version; what it may never do is reuse an old one.)
    """
    sm = table.snapshot_manager
    prev_sid = prev_version = None
    by_version: dict = {}
    for sid in ids:
        try:
            snap = sm.snapshot(sid)
        except (FileNotFoundError, OSError, ValueError, KeyError):
            continue   # missing/corrupt: reported by the graph walk
        try:
            stamp = stamp_from_properties(snap.properties or {})
        except ValueError:
            report.add(ViolationKind.OWNERSHIP_INCONSISTENCY,
                       f"{SNAPSHOT_PREFIX}{sid}",
                       "unparsable multihost.ownership.* properties",
                       sid)
            continue
        if stamp is None:
            continue
        stamped_map = stamp
        version = stamped_map.version
        shape = (stamped_map.num_processes, stamped_map.num_buckets)
        dead = stamped_map.dead
        if prev_version is not None and version < prev_version:
            report.add(
                ViolationKind.OWNERSHIP_INCONSISTENCY,
                f"{SNAPSHOT_PREFIX}{sid}",
                f"ownership version regressed: snapshot {prev_sid} "
                f"stamped v{prev_version}, later snapshot {sid} "
                f"stamps v{version}", sid)
        recorded = by_version.get(version)
        if recorded is None:
            by_version[version] = (shape, dead, sid)
        elif recorded[0] != shape or recorded[1] != dead:
            report.add(
                ViolationKind.OWNERSHIP_INCONSISTENCY,
                f"{SNAPSHOT_PREFIX}{sid}",
                f"ownership version {version} denotes two different "
                f"maps: snapshot {recorded[2]} records "
                f"processes/buckets {recorded[0]} dead "
                f"{sorted(recorded[1])}, snapshot {sid} records "
                f"{shape} dead {sorted(dead)}", sid)
        prev_sid, prev_version = sid, version


def _check_chain(table, report: FsckReport) -> List[int]:
    """Snapshot chain contiguity + EARLIEST/LATEST hint validity.
    Returns the sorted existing snapshot ids."""
    sm = table.snapshot_manager
    ids = sm._all_ids()
    if ids:
        # ids folded out of the middle by the heartbeat-folding pass
        # (maintenance/expire.py) are legitimate holes, not torn expiry
        missing = sorted(set(range(ids[0], ids[-1] + 1)) - set(ids)
                         - sm.folded_ids())
        for sid in missing:
            report.add(ViolationKind.SNAPSHOT_GAP,
                       f"{SNAPSHOT_PREFIX}{sid}",
                       f"snapshot {sid} missing from the chain "
                       f"[{ids[0]}..{ids[-1]}]", sid)
    for name in (EARLIEST, LATEST):
        hint = sm._hint(name)
        if hint is not None and not sm.snapshot_exists(hint):
            report.add(ViolationKind.BAD_HINT, name,
                       f"{name} hint points at missing snapshot "
                       f"{hint}")
    return ids


def fsck(table, snapshot_id: Optional[int] = None,
         all_snapshots: bool = True, deep: bool = False,
         incremental: bool = False,
         stamp_watermark: bool = False) -> FsckReport:
    """Verify the table's snapshot→manifest→file graph; returns an
    `FsckReport` of typed violations (empty = healthy).

    `snapshot_id` restricts the graph walk to one snapshot;
    `all_snapshots=False` checks only the latest.  `deep=True`
    additionally reads every live data file and compares actual row
    counts against manifest stats (IO-heavy).  The snapshot chain and
    hint files are always checked.

    `incremental=True` rides the last clean sweep's watermark
    (maintenance/watermark.py): only snapshots committed after it are
    walked, and only manifests it did not already prove are decoded —
    O(delta), not O(table).  An absent, expired, or invalidated
    watermark (rollback_to / fast_forward recreated the stamped id)
    silently demotes to a full pass; `report.incremental` records
    which actually ran.  The level-overlap and absolute row-count
    invariants need the merged live set and are only checked by the
    full pass — run one periodically as the oracle.

    `stamp_watermark=True` records a clean full-chain verification at
    the tip via one small forced commit, arming the next incremental
    run.  Never stamped when violations were found or when the walk
    was partial (`snapshot_id`/`all_snapshots=False`)."""
    from paimon_tpu_torch.maintenance.watermark import (
        FSCK_WATERMARK_PREFIX, read_watermark, validate_watermark,
    )
    from paimon_tpu_torch.maintenance.watermark import (
        stamp_watermark as _stamp_watermark,
    )
    from paimon_tpu_torch.metrics import (
        FLEET_FSCK_INCREMENTAL_RUNS, FLEET_FSCK_OBJECTS_CHECKED,
        FLEET_FSCK_WATERMARK_AGE_MS, FSCK_VIOLATIONS, global_registry,
    )

    report = FsckReport()
    ids = _check_chain(table, report)
    if not ids:
        return report
    sm = table.snapshot_manager

    wm = wm_snap = None
    if incremental and snapshot_id is None:
        wm = read_watermark(table, FSCK_WATERMARK_PREFIX)
        if wm is not None and validate_watermark(table, wm):
            try:
                wm_snap = sm.snapshot(wm.snapshot_id)
            except Exception:               # noqa: BLE001
                wm_snap = None
        if wm_snap is None:
            wm = None           # absent/expired/rolled-back: full

    walker = _GraphWalker(table, report, deep)
    if wm_snap is not None and not walker.seed_from(wm_snap):
        wm = wm_snap = None     # seed lists unreadable: full pass
    report.incremental = wm is not None

    # chain-level multihost ownership consistency (cheap: properties
    # only, no manifest IO) — always on, like the hint checks; the
    # incremental run re-anchors at the watermark snapshot so version
    # monotonicity is checked ACROSS the sweep boundary
    own_ids = ids if wm is None \
        else [i for i in ids if i >= wm.snapshot_id]
    _check_ownership_chain(table, report, own_ids)

    if snapshot_id is not None:
        targets = [snapshot_id] if snapshot_id in ids else []
        if not targets:
            report.add(ViolationKind.SNAPSHOT_GAP,
                       f"{SNAPSHOT_PREFIX}{snapshot_id}",
                       f"requested snapshot {snapshot_id} does not "
                       f"exist", snapshot_id)
    elif wm is not None:
        targets = [i for i in ids if i > wm.snapshot_id]
    elif all_snapshots:
        targets = ids
    else:
        targets = [ids[-1]]

    prev = wm_snap
    for sid in targets:
        try:
            snap = sm.snapshot(sid)
        except FileNotFoundError:
            prev = None                     # raced an expire; chain
            continue
        except Exception as e:              # noqa: BLE001
            report.add(ViolationKind.CORRUPT_SNAPSHOT,
                       f"{SNAPSHOT_PREFIX}{sid}",
                       f"snapshot file undecodable: {e}", sid)
            prev = None     # arithmetic check re-anchors at next good
            continue
        if wm is not None:
            walker.check_snapshot_delta(snap, prev)
            prev = snap
        else:
            walker.check_snapshot(snap)

    if incremental and snapshot_id is None:
        fleet = global_registry().fleet_metrics()
        fleet.counter(FLEET_FSCK_INCREMENTAL_RUNS).inc()
        fleet.counter(FLEET_FSCK_OBJECTS_CHECKED).inc(
            report.snapshots_checked + report.manifests_checked
            + report.data_files_checked)
        if wm is not None:
            import time as _time
            fleet.gauge(FLEET_FSCK_WATERMARK_AGE_MS).set(
                max(0, int(_time.time() * 1000) - wm.ts_ms))

    if report.violations:
        global_registry().maintenance_metrics().counter(
            FSCK_VIOLATIONS).inc(len(report.violations))
    elif stamp_watermark and snapshot_id is None and \
            (all_snapshots or incremental):
        _stamp_watermark(table, FSCK_WATERMARK_PREFIX,
                         commit_user="fsck")
    return report
