"""Row-level DELETE.

Counterpart of paimon_tpu/index/dv_maintainer.py for primary-key
tables: a DELETE writes -D records through the normal merge path
(reference semantics).  Append tables' deletion vectors (the DV file,
its read mask and the append delete) are not ported yet (ROADMAP.md
A.8.7); their entry points raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from paimon_tpu_torch.types import RowKind

__all__ = ["delete_where"]


def delete_where(table, predicate) -> Optional[int]:
    """Delete all rows matching `predicate`. Returns the snapshot id, or
    None when nothing matched."""
    if table.primary_keys:
        return _delete_pk(table, predicate)
    return _delete_append_dv(table, predicate)


def _delete_pk(table, predicate) -> Optional[int]:
    rows = table.to_arrow(predicate=predicate)
    if rows.num_rows == 0:
        return None
    wb = table.new_batch_write_builder()
    with wb.new_write(apply_defaults=False) as w:
        w.write_arrow(rows.select([f.name for f in table.schema.fields]),
                      row_kinds=np.full(rows.num_rows, RowKind.DELETE,
                                        np.int8))
        sid = wb.new_commit().commit(w.prepare_commit())
    return sid


def _delete_append_dv(table, predicate, max_retries: int = 5):
    raise NotImplementedError(
        "deletion vectors of append tables are not ported to "
        "paimon_tpu_torch yet (ROADMAP.md: A.8.7)")


def replace_bucket_dv_entries(*args, **kwargs):
    raise NotImplementedError(
        "deletion-vector index files are not ported to paimon_tpu_torch "
        "yet (ROADMAP.md: A.8.7)")
