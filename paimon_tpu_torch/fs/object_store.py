"""Object-store error types.

Counterpart of paimon_tpu/fs/object_store.py, holding only the error
that the fault taxonomy (parallel/fault.py) classifies; the object-store
FileIO itself is not ported yet (ROADMAP.md A.7).
"""

from __future__ import annotations

__all__ = ["TransientStoreError"]


class TransientStoreError(Exception):
    """A retryable store-side failure (HTTP 503 SlowDown and the like)."""
