"""Clone a table's CURRENT state into a new table.

reference: flink/procedure/CloneProcedure + clone/ actions — copy the
latest snapshot's data files into a fresh table and commit them, so
the clone is an independent table (its own snapshots/manifests) whose
content equals the source at clone time. Used for DR copies, dev
sandboxes, and engine hand-offs.

Counterpart of paimon_tpu/maintenance/clone.py: the clone opens on the
target catalog's device.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["clone_table"]


def clone_table(catalog, source_identifier: str, target_identifier: str,
                ignore_if_exists: bool = False):
    """Create `target_identifier` with the source's schema (minus
    write-only) and commit copies of every data file the source's
    latest snapshot references. Returns the target table."""
    import dataclasses

    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.core.write import CommitMessage
    from paimon_tpu_torch.schema import Schema

    src = catalog.get_table(source_identifier)
    schema = Schema(
        fields=list(src.schema.fields),
        partition_keys=list(src.schema.partition_keys),
        primary_keys=list(src.schema.primary_keys),
        options=dict(src.schema.options),
        comment=getattr(src.schema, "comment", ""),
    )
    target = catalog.create_table(target_identifier, schema,
                                  ignore_if_exists=ignore_if_exists)

    # cloned DataFileMetas keep their schema_id, which indexes the
    # SOURCE's schema history — replicate that history verbatim so
    # field-id evolution resolves identically on the clone (without
    # this, a clone of an ALTERed table is unreadable)
    src_ids = src.schema_manager.list_all_ids()
    if src_ids != [target.schema.id] or src.schema.id != target.schema.id:
        for sid in src_ids:
            target.file_io.write_bytes(
                target.schema_manager.schema_path(sid),
                src.file_io.read_bytes(
                    src.schema_manager.schema_path(sid)),
                overwrite=True)
        from paimon_tpu_torch.table.table import FileStoreTable
        target = FileStoreTable.load(target.path, target.file_io,
                                   device=target.device)

    snapshot = src.snapshot_manager.latest_snapshot()
    if snapshot is None:
        return target

    src_scan = src.new_scan()
    dst_pf = target.new_scan().path_factory
    # deletion vectors key on FILE NAMES, which the clone renames:
    # collect the source DVs and re-key them for the target commit
    dv_index = src_scan._load_deletion_vectors(snapshot)
    renamed_dvs: Dict[Tuple, Dict] = {}
    msgs: Dict[Tuple, CommitMessage] = {}
    for e in src_scan.read_entries(snapshot):
        if e.bucket == -2:
            continue                   # postpone staging is not state
        partition = src_scan._partition_codec.from_bytes(e.partition)
        src_path = e.file.external_path or \
            src_scan.path_factory.data_file_path(partition, e.bucket,
                                                 e.file.file_name)
        ext = e.file.file_name.rsplit(".", 1)[-1]
        name = dst_pf.new_data_file_name(ext)
        dst_path, external = dst_pf.new_data_file_location(
            partition, e.bucket, name)
        target.file_io.write_bytes(dst_path,
                                   src.file_io.read_bytes(src_path),
                                   overwrite=False)
        # sidecars (blob payloads, index files) live next to the data
        # file under the SAME name prefix — rewrite the prefix ONCE so
        # the copied names and the committed meta can never diverge
        old_prefix = e.file.file_name.rsplit(".", 1)[0]
        new_prefix = name.rsplit(".", 1)[0]
        new_extras = [x.replace(old_prefix, new_prefix)
                      for x in e.file.extra_files]
        for extra, new_extra in zip(e.file.extra_files, new_extras):
            target.file_io.write_bytes(
                dst_pf.data_file_path(partition, e.bucket, new_extra),
                src.file_io.read_bytes(src_scan.path_factory
                                       .data_file_path(partition,
                                                       e.bucket, extra)),
                overwrite=False)
        meta = dataclasses.replace(
            e.file, file_name=name, external_path=external,
            extra_files=new_extras)
        m = msgs.setdefault((e.partition, e.bucket), CommitMessage(
            partition, e.bucket, e.total_buckets))
        m.new_files.append(meta)
        bucket_dvs = dv_index.get((e.partition, e.bucket)) or {}
        if e.file.file_name in bucket_dvs:
            renamed_dvs.setdefault((e.partition, e.bucket), {})[name] = \
                bucket_dvs[e.file.file_name]

    index_entries = []
    if renamed_dvs:
        from paimon_tpu_torch.index.deletion_vector import (
            DeletionVectorsIndexFile,
        )
        from paimon_tpu_torch.manifest import FileKind
        from paimon_tpu_torch.manifest.index_manifest import (
            DELETION_VECTORS_INDEX, IndexFileMeta, IndexManifestEntry,
        )
        dv_file = DeletionVectorsIndexFile(target.file_io,
                                           f"{target.path}/index")
        for (pbytes, bucket), dvs in renamed_dvs.items():
            fname, size, ranges = dv_file.write(
                dvs, path_factory=dst_pf)
            index_entries.append(IndexManifestEntry(
                FileKind.ADD, pbytes, bucket,
                IndexFileMeta(DELETION_VECTORS_INDEX, fname, size,
                              sum(d.cardinality() for d in dvs.values()),
                              dv_ranges=ranges)))

    if msgs:
        commit = FileStoreCommit(target.file_io, target.path,
                                 target.schema, target.options,
                                 branch=target.branch)
        commit.commit(list(msgs.values()),
                      index_entries=index_entries or None)
    from paimon_tpu_torch.table.table import FileStoreTable
    return FileStoreTable.load(target.path, target.file_io,
                               device=target.device)
