"""Migrate a plain file table into a paimon table without rewriting
data.

Counterpart of paimon_tpu/maintenance/migrate.py, which takes a catalog
and creates an append table over a format table: neither is ported, so
`migrate_table` raises NotImplementedError naming its ROADMAP.md item
(A.8.9, beside `catalog/`).
"""

from __future__ import annotations

__all__ = ["migrate_table"]


def migrate_table(catalog, source_dir: str, identifier: str,
                  file_format: str = "parquet", move: bool = True):
    raise NotImplementedError(
        "migrate_table is not ported to paimon_tpu_torch yet "
        "(ROADMAP.md: A.8.9)")
