"""Migrate a plain file table (hive-style directory of parquet/orc
files) into a paimon table WITHOUT rewriting data.

reference: flink/procedure/MigrateTableProcedure +
migrate/FileMigrationUtils: paimon data files for append tables are
plain value-column files, so migration is metadata work — move each
source file into the table layout and commit manifest entries over it.
Row counts and the schema come from file footers (no data scan); the
schema is the first file's plus hive partition directory keys.

Counterpart of paimon_tpu/maintenance/migrate.py, which decodes the
whole first file for its schema; the migrated table opens on the
catalog's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import pyarrow as pa

__all__ = ["migrate_table"]


def _footer(file_io, path: str, fmt: str):
    """(arrow schema, row count) from the file FOOTER only — migration
    never scans data. Local paths open directly; other FileIOs go
    through a buffer."""
    import os as _os
    import pyarrow.parquet as pq
    source = path if _os.path.exists(path) else \
        pa.BufferReader(file_io.read_bytes(path))
    if fmt == "parquet":
        f = pq.ParquetFile(source)
        return f.schema_arrow, f.metadata.num_rows
    if fmt == "orc":
        import pyarrow.orc as orc
        f = orc.ORCFile(source)
        return f.schema, f.nrows
    raise ValueError(f"migrate supports parquet/orc, not {fmt!r}")


def migrate_table(catalog, source_dir: str, identifier: str,
                  file_format: str = "parquet",
                  move: bool = True):
    """Create `identifier` as an unaware-bucket append table whose data
    files ARE the source directory's files (moved when `move`, copied
    otherwise). Hive-style `k=v` segments become string partition
    columns. Returns the new table."""
    from paimon_tpu_torch.fs.fileio import get_file_io
    from paimon_tpu_torch.core.write import CommitMessage
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.manifest import DataFileMeta, SimpleStats
    from paimon_tpu_torch.schema import Schema
    from paimon_tpu_torch.table.format_table import FormatTable
    from paimon_tpu_torch.types import data_type_from_arrow, VarCharType

    file_io = get_file_io(source_dir)
    src = FormatTable(source_dir, file_format, file_io)
    files = src._data_files()
    if not files:
        raise ValueError(f"no .{file_format} files under {source_dir}")

    # schema: first file's arrow schema + partition dir keys as strings
    first_schema, _ = _footer(file_io, files[0], file_format)
    part_keys = list(src._partition_of(files[0], src.path))
    b = Schema.builder()
    for f in first_schema:
        b = b.column(f.name, data_type_from_arrow(f.type))
    for k in part_keys:
        if k not in first_schema.names:
            b = b.column(k, VarCharType.string_type())
    if part_keys:
        b = b.partition_keys(*part_keys)
    schema = b.options({"bucket": "-1",
                        "file.format": file_format}).build()
    table = catalog.create_table(identifier, schema)
    pf = table.new_scan().path_factory

    # group source files per partition, preserve listing order as the
    # sequence order
    msgs: Dict[Tuple, CommitMessage] = {}
    seq = 0
    fmt_ext = src.format.extension
    for path in files:
        part_map = src._partition_of(path, src.path)
        if list(part_map) != part_keys:
            raise ValueError(
                f"inconsistent partition layout at {path}: "
                f"{list(part_map)} != {part_keys}")
        partition = tuple(part_map[k] for k in part_keys)
        _, rows = _footer(file_io, path, file_format)
        size = file_io.get_file_size(path)
        name = pf.new_data_file_name(fmt_ext)
        dest = pf.data_file_path(partition, 0, name)
        if move:
            if not file_io.rename(path, dest):
                raise RuntimeError(f"moving {path} -> {dest} failed")
        else:
            file_io.write_bytes(dest, file_io.read_bytes(path),
                                overwrite=False)
        meta = DataFileMeta(
            file_name=name, file_size=size, row_count=rows,
            min_key=b"", max_key=b"", key_stats=SimpleStats.EMPTY,
            value_stats=SimpleStats.EMPTY,
            min_sequence_number=seq,
            max_sequence_number=seq + rows - 1,
            schema_id=table.schema.id, level=0)
        seq += rows
        m = msgs.setdefault(partition, CommitMessage(
            partition, 0, 1))
        m.new_files.append(meta)

    commit = FileStoreCommit(table.file_io, table.path, table.schema,
                             table.options, branch=table.branch)
    commit.commit(list(msgs.values()))
    from paimon_tpu_torch.table.table import FileStoreTable
    return FileStoreTable.load(table.path, table.file_io,
                               device=table.device)
