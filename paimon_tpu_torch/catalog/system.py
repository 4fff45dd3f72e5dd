"""Catalog-level (`sys` database) system tables.

reference: table/system/{AllTablesTable, AllPartitionsTable,
AllTableOptionsTable, CatalogOptionsTable}.java +
SystemTableLoader.loadGlobal — global views that enumerate every
database/table of the catalog, surfaced in SQL as `sys.all_tables`
etc. and via `catalog.system_table(name)`.
"""

from typing import Callable, Dict

import pyarrow as pa

__all__ = ["GLOBAL_SYSTEM_TABLES", "load_global_system_table"]


def _each_table(catalog):
    from paimon_tpu_torch.catalog.catalog import Identifier

    for db in sorted(catalog.list_databases()):
        for name in sorted(catalog.list_tables(db)):
            try:
                yield db, name, catalog.get_table(Identifier(db, name))
            # lint-ok: swallow warehouse-wide iteration skips tables
            # that fail to load — one broken table must not hide every
            # other table from the system catalog
            except Exception:        # noqa: BLE001 — skip broken tables
                continue


def all_tables(catalog) -> pa.Table:
    rows = []
    for db, name, table in _each_table(catalog):
        snap = table.latest_snapshot()
        rows.append({
            "database_name": db,
            "table_name": name,
            "comment": table.schema.comment or None,
            "record_count": snap.total_record_count if snap else 0,
            "snapshot_id": snap.id if snap else None,
        })
    return pa.Table.from_pylist(rows, schema=pa.schema([
        ("database_name", pa.string()), ("table_name", pa.string()),
        ("comment", pa.string()), ("record_count", pa.int64()),
        ("snapshot_id", pa.int64())]))


def all_partitions(catalog) -> pa.Table:
    rows = []
    for db, name, table in _each_table(catalog):
        if not table.partition_keys:
            continue
        parts = table.system_table("partitions")
        for r in parts.to_pylist():
            rows.append({
                "database_name": db,
                "table_name": name,
                "partition": r.get("partition"),
                "record_count": r.get("record_count"),
                "file_count": r.get("file_count"),
            })
    return pa.Table.from_pylist(rows, schema=pa.schema([
        ("database_name", pa.string()), ("table_name", pa.string()),
        ("partition", pa.string()), ("record_count", pa.int64()),
        ("file_count", pa.int64())]))


def all_table_options(catalog) -> pa.Table:
    rows = []
    for db, name, table in _each_table(catalog):
        for k, v in sorted(table.schema.options.items()):
            rows.append({"database_name": db, "table_name": name,
                         "key": k, "value": str(v)})
    return pa.Table.from_pylist(rows, schema=pa.schema([
        ("database_name", pa.string()), ("table_name", pa.string()),
        ("key", pa.string()), ("value", pa.string())]))


def catalog_options(catalog) -> pa.Table:
    opts = getattr(catalog, "options", None) or {}
    if hasattr(catalog, "warehouse"):
        opts = {"warehouse": catalog.warehouse, **dict(opts)}
    return pa.table({
        "key": pa.array([k for k in sorted(opts)], pa.string()),
        "value": pa.array([str(opts[k]) for k in sorted(opts)],
                          pa.string()),
    })


GLOBAL_SYSTEM_TABLES: Dict[str, Callable] = {
    "all_tables": all_tables,
    "all_partitions": all_partitions,
    "all_table_options": all_table_options,
    "catalog_options": catalog_options,
}


def load_global_system_table(catalog, name: str) -> pa.Table:
    key = name.lower()
    if key not in GLOBAL_SYSTEM_TABLES:
        raise ValueError(f"unknown global system table {name!r}; have "
                         f"{sorted(GLOBAL_SYSTEM_TABLES)}")
    return GLOBAL_SYSTEM_TABLES[key](catalog)
