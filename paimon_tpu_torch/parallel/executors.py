"""Shared thread/executor construction helpers.

Counterpart of paimon_tpu/parallel/executors.py: every pool and
background thread of this package is created here, with a mandatory
name so a leaked thread can be attributed to its subsystem.  Pools
carry the submitter's request deadline (utils/deadline.py) into each
task.
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


class _DeadlinePropagatingPool(ThreadPoolExecutor):
    """Runs each task under the submitting thread's request deadline:
    context variables do not cross pool boundaries on their own."""

    def submit(self, fn, /, *args, **kwargs):
        from paimon_tpu_torch.utils.deadline import (
            current_deadline, run_with_deadline,
        )
        dl = current_deadline()
        if dl is None:
            return super().submit(fn, *args, **kwargs)
        return super().submit(run_with_deadline, dl, fn, *args, **kwargs)


def new_thread_pool(workers: int, prefix: str) -> ThreadPoolExecutor:
    """A named ThreadPoolExecutor (`prefix` becomes the thread-name
    prefix) whose tasks inherit the submitter's request deadline."""
    return _DeadlinePropagatingPool(max_workers=max(1, int(workers)),
                                    thread_name_prefix=prefix)
