"""The process-wide part of tail-tolerant store access.

Counterpart of paimon_tpu/fs/resilience.py:60-128: the degraded switch
that the serving plane's brownout ladder flips (service/brownout.py),
`hedging_allowed`, and `breaker_states`.  The resilient object-store
backend with its hedged reads and circuit breakers is not ported yet
(ROADMAP.md A.7b): the port has no object-store FileIO, so no breaker
exists and `breaker_states()` is empty.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["set_degraded_for", "is_degraded", "hedging_allowed",
           "breaker_states"]

# the process is degraded while ANY source (one BrownoutController per
# query server) says so: one server recovering or stopping must not
# clear another's brownout
_DEGRADED = False
_DEGRADED_LOCK = threading.Lock()
_DEGRADED_SOURCES: set = set()


def set_degraded_for(source, active: bool):
    """Mark one source degraded or recovered; the process-wide switch
    is the OR over live sources."""
    global _DEGRADED
    with _DEGRADED_LOCK:
        if active:
            _DEGRADED_SOURCES.add(source)
        else:
            _DEGRADED_SOURCES.discard(source)
        _DEGRADED = bool(_DEGRADED_SOURCES)


def is_degraded() -> bool:
    return _DEGRADED


def hedging_allowed() -> bool:
    return not _DEGRADED


def breaker_states() -> Dict[str, str]:
    """{backend name: breaker state} of every live resilient backend:
    none exist until the object-store backend is ported."""
    return {}
