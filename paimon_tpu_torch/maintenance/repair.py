"""Repair actions: reconcile metadata with what storage actually holds.

reference: flink/action/RemoveUnexistingFilesAction (+ its procedure)
— manifests can reference data files a human or broken tool deleted;
every scan then fails. The repair commits DELETE entries for the
missing files so the table becomes readable again (data in those files
is gone either way).

Counterpart of paimon_tpu/maintenance/repair.py, with
`rewrite_file_index`, which retrofits per-file column indexes onto a
table's existing data files.
"""

from __future__ import annotations

from typing import List

__all__ = ["remove_unexisting_files", "remove_unexisting_manifests",
           "compact_manifests", "rewrite_file_index", "fix_violations"]


def fix_violations(table, report) -> List[str]:
    """Map an FsckReport's FIXABLE violation classes onto the repair
    actions below (the `fsck --fix` backend).  Repairs apply to the
    LATEST snapshot — violations pinned in older snapshots heal by
    snapshot expiration.  Returns the action names run, in order."""
    from paimon_tpu_torch.maintenance.fsck import ViolationKind

    kinds = report.kinds()
    actions: List[str] = []
    # corrupt manifests must be dropped first: the chain rewrite can
    # skip MISSING files but chokes on undecodable ones
    corrupt = report.by_kind(ViolationKind.CORRUPT_MANIFEST)
    if corrupt:
        scan = table.new_scan()
        for v in corrupt:
            table.file_io.delete_quietly(
                scan.manifest_file.path(v.obj))
        actions.append("drop-corrupt-manifests")
    if corrupt or ViolationKind.MISSING_MANIFEST in kinds:
        remove_unexisting_manifests(table)
        actions.append("remove-unexisting-manifests")
    if ViolationKind.DANGLING_DATA_FILE in kinds:
        remove_unexisting_files(table)
        actions.append("remove-unexisting-files")
    if ViolationKind.ROW_COUNT_MISMATCH in kinds and \
            "remove-unexisting-manifests" not in actions:
        # the full manifest rewrite recounts every live entry, fixing
        # a drifted totalRecordCount (it also ran implicitly above)
        compact_manifests(table)
        actions.append("compact-manifests")
    if ViolationKind.BAD_HINT in kinds:
        sm = table.snapshot_manager
        ids = sm._all_ids()
        if ids:
            sm.commit_earliest_hint(ids[0])
            sm.commit_latest_hint(ids[-1])
        actions.append("rewrite-hints")
    return actions


def remove_unexisting_files(table, dry_run: bool = False) -> List[str]:
    """Commit DELETE manifest entries for referenced data files that no
    longer exist on storage. Returns the missing paths (dry_run only
    reports). External-path files are checked at their recorded
    location."""
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.write import CommitMessage

    from concurrent.futures import ThreadPoolExecutor

    from paimon_tpu_torch.options import CoreOptions

    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return []
    scan = table.new_scan()
    entries = list(scan.read_entries(snapshot))
    paths = []
    for e in entries:
        partition = scan._partition_codec.from_bytes(e.partition)
        paths.append(
            e.file.external_path or scan.path_factory.data_file_path(
                partition, e.bucket, e.file.file_name))
    # existence probes are HEADs on object storage: fan out (same
    # pattern/knob as file deletion, delete-file.thread-num)
    workers = max(1, table.options.get(
        CoreOptions.DELETE_FILE_THREAD_NUM) or 4)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        exists = list(pool.map(table.file_io.exists, paths))
    missing_paths: List[str] = []
    msgs = {}
    for e, path, ok in zip(entries, paths, exists):
        if ok:
            continue
        partition = scan._partition_codec.from_bytes(e.partition)
        m = msgs.setdefault(
            (e.partition, e.bucket),
            CommitMessage(partition, e.bucket, e.total_buckets))
        m.compact_before.append(e.file)
        missing_paths.append(path)
    if dry_run or not msgs:
        return missing_paths
    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    commit.commit(list(msgs.values()))
    return missing_paths


def rewrite_file_index(table, force: bool = False) -> int:
    """Build per-file indexes (bloom, bitmap, bsi, range-bitmap per the
    table's current file-index.* options) and commit the updated metas
    (reference flink/procedure/RewriteFileIndexProcedure).  By default
    only files without any index are processed; `force=True` rebuilds
    every file, which a change of the file-index.* spec needs.  Returns
    the number of files whose index was (re)written."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.kv_file import read_kv_file
    from paimon_tpu_torch.core.write import CommitMessage
    from paimon_tpu_torch.index.bloom import place_file_index
    from paimon_tpu_torch.index.file_index import build_indexes_blob
    from paimon_tpu_torch.options import CoreOptions

    spec = table.options.file_index_spec
    if not spec:
        raise ValueError("no file-index.*.columns configured")
    snapshot = table.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return 0
    scan = table.new_scan()
    threshold = table.options.get(
        CoreOptions.FILE_INDEX_IN_MANIFEST_THRESHOLD)
    fpp = table.options.get(CoreOptions.FILE_INDEX_BLOOM_FPP)
    todo = []
    for e in scan.read_entries(snapshot):
        if e.bucket == -2:
            continue
        f = e.file
        if not force and (f.embedded_index is not None or
                          any(x.endswith(".index")
                              for x in f.extra_files)):
            continue                      # already indexed
        todo.append(e)

    def build_one(e):
        f = e.file
        partition = scan._partition_codec.from_bytes(e.partition)
        data = read_kv_file(table.file_io, scan.path_factory, partition,
                            e.bucket, f, schema=table.schema,
                            schema_manager=table.schema_manager,
                            options=table.options, device=table.device)
        blob = build_indexes_blob(data, spec, fpp)
        if blob is None:
            return None
        # a crashed or forced earlier run may have left this sidecar:
        # the rewrite owns the name, so placement never finds it taken
        table.file_io.delete_quietly(scan.path_factory.data_file_path(
            partition, e.bucket, f.file_name + ".index"))
        embedded, extras = place_file_index(
            table.file_io, scan.path_factory, partition, e.bucket,
            f.file_name, blob, threshold)
        return dataclasses.replace(
            f, embedded_index=embedded,
            extra_files=[x for x in f.extra_files
                         if not x.endswith(".index")] + extras)

    workers = max(1, table.options.get(
        CoreOptions.DELETE_FILE_THREAD_NUM) or 4)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        new_metas = list(pool.map(build_one, todo))

    msgs = {}
    rewritten = 0
    for e, new_meta in zip(todo, new_metas):
        if new_meta is None:
            continue
        partition = scan._partition_codec.from_bytes(e.partition)
        m = msgs.setdefault((e.partition, e.bucket), CommitMessage(
            partition, e.bucket, e.total_buckets))
        m.compact_before.append(e.file)
        m.compact_after.append(new_meta)
        rewritten += 1
    if msgs:
        FileStoreCommit(table.file_io, table.path, table.schema,
                        table.options, branch=table.branch).commit(
            list(msgs.values()))
    return rewritten


def compact_manifests(table):
    """Force a full manifest rewrite (fold DELETEs, one merged
    manifest) committed as a COMPACT snapshot (reference
    flink/procedure/CompactManifestProcedure)."""
    from paimon_tpu_torch.core.commit import FileStoreCommit

    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit.compact_manifests()


def remove_unexisting_manifests(table):
    """Repair a table whose manifest FILES were deleted out of band:
    rewrite the manifest chain from whatever manifests still exist
    (their entries are unrecoverable and drop out) — reference
    flink/procedure/RemoveUnexistingManifestsProcedure. Returns the
    new snapshot id, or None when nothing was committed."""
    from paimon_tpu_torch.core.commit import FileStoreCommit

    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    return commit.compact_manifests(skip_missing=True)
