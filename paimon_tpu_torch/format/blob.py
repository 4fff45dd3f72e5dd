"""Blob columns.

Counterpart of paimon_tpu/format/blob.py, reduced to blob detection:
the blob sidecar files themselves are not ported yet (ROADMAP.md
A.8.8).
"""

from __future__ import annotations

from typing import List

from paimon_tpu_torch.types import BlobType

__all__ = ["blob_column_names"]


def blob_column_names(schema) -> List[str]:
    """Blob-typed field names of a TableSchema."""
    return [f.name for f in schema.fields if isinstance(f.type, BlobType)]
