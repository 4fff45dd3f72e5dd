"""Object-store error types.

Counterpart of paimon_tpu/fs/object_store.py, holding only the error
that the fault taxonomy (parallel/fault.py) classifies as transient, and
so the read, write and upload retries retry; the object-store FileIO
itself is not ported yet (ROADMAP.md A.7b).
"""

from __future__ import annotations

__all__ = ["TransientStoreError"]


class TransientStoreError(Exception):
    """A retryable store-side failure (HTTP 503 SlowDown and the like)."""
