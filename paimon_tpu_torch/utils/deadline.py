"""Request deadlines.

Counterpart of paimon_tpu/utils/deadline.py, holding only the error
that the fault taxonomy (parallel/fault.py) classifies; deadlines
themselves (request.timeout) are not ported yet (ROADMAP.md A.7), and
the table refuses that option.
"""

from __future__ import annotations

__all__ = ["DeadlineExceededError"]


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end budget is spent; never retried."""
