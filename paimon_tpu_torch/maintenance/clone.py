"""Clone a table's current state into a new table.

Counterpart of paimon_tpu/maintenance/clone.py, which takes a catalog:
catalogs are not ported, so `clone_table` raises NotImplementedError
naming its ROADMAP.md item (A.8.9, beside `catalog/`).
"""

from __future__ import annotations

__all__ = ["clone_table"]


def clone_table(catalog, source_identifier: str, target_identifier: str,
                ignore_if_exists: bool = False):
    raise NotImplementedError(
        "clone_table is not ported to paimon_tpu_torch yet "
        "(ROADMAP.md: A.8.9)")
