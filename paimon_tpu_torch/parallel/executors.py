"""Shared thread/executor construction helpers.

Counterpart of paimon_tpu/parallel/executors.py (without request
deadlines, which are not ported yet): every pool and background thread
of this package is created here, with a mandatory name so a leaked
thread can be attributed to its subsystem.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

__all__ = ["spawn_thread", "new_thread_pool"]


def spawn_thread(target: Callable, *, name: str,
                 daemon: bool = True, start: bool = True,
                 args: Sequence = ()) -> threading.Thread:
    """Create (and by default start) a named background thread."""
    t = threading.Thread(target=target, name=name, daemon=daemon,
                         args=tuple(args))
    if start:
        t.start()
    return t


def new_thread_pool(workers: int, prefix: str) -> ThreadPoolExecutor:
    """A named ThreadPoolExecutor (`prefix` becomes the thread-name
    prefix)."""
    return ThreadPoolExecutor(max_workers=max(1, int(workers)),
                              thread_name_prefix=prefix)
