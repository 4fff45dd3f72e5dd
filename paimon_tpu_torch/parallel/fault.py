"""Fault classification and the per-bucket retry policy of the mesh
compaction.

Counterpart of paimon_tpu/parallel/fault.py.  The mesh engine
(parallel/mesh_engine.py) treats a bucket as its failure domain: a
transient error anywhere in one bucket's window stream (reading a
sorted run, the window merge, writing an output file) aborts and
retries that bucket with capped decorrelated-jitter backoff, and after
`compaction.retry.max-attempts` degrades it to the single-chip
compact/manager.py path instead of failing the whole job:

    mesh window stream  ->  retry (x max-attempts, jittered backoff)
                        ->  single-chip fallback (compaction.mesh.fallback)
                        ->  raise (bucket unrecoverable; job fails)

Only transient errors ride the ladder; programming errors propagate at
once.

Device and lane loss.  The reference recognises device loss by the
class name `XlaRuntimeError`.  Here a lane is a device of a
`torch.distributed` group or a batch row on one card, and these count
as its loss, matched by class name so this module imports no torch:
- `AcceleratorError`: torch's error for a failing CUDA runtime call
  (a lost or faulted card, an ECC error); a sticky fault fails the
  retries and the fallback too, so the ladder ends in a raise;
- `DistBackendError`, `DistNetworkError`: a collective whose peer
  process or link died.
Everything else of RuntimeError is NOT transient: the winner-select
wrapper's own "eq_next_mask kernel launch failed" and a failed nvcc
build (both plain RuntimeError) propagate at once, so the ladder never
hides a broken kernel behind the single-chip fallback (which runs on
the same card through the same kernel, in 1-D launches).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from paimon_tpu_torch.options import CoreOptions

__all__ = ["is_transient_error", "BucketRetryPolicy"]

_DEVICE_ERROR_NAMES = frozenset({"AcceleratorError", "DistBackendError",
                                 "DistNetworkError"})


def is_transient_error(exc: BaseException) -> bool:
    """True when `exc` is worth retrying: a store-side 503
    (TransientStoreError), an IO fault (OSError, among them injected
    faults and FileNotFoundError from racing maintenance), or a device
    or lane loss (module docstring).  Decode errors (CorruptDataError,
    pyarrow's ArrowException) and spent deadlines never retry."""
    import pyarrow as pa

    from paimon_tpu_torch.format.format import CorruptDataError
    from paimon_tpu_torch.fs.object_store import TransientStoreError
    from paimon_tpu_torch.utils.deadline import DeadlineExceededError

    if isinstance(exc, (CorruptDataError, pa.ArrowException,
                        DeadlineExceededError)):
        return False
    if isinstance(exc, (TransientStoreError, OSError)):
        return True
    return any(t.__name__ in _DEVICE_ERROR_NAMES
               for t in type(exc).__mro__)


@dataclass
class BucketRetryPolicy:
    """`compaction.retry.*` and `compaction.mesh.fallback` in one bundle."""

    max_attempts: int = 3
    backoff_base_ms: float = 10.0
    fallback: bool = True
    rng: Optional[random.Random] = None

    @classmethod
    def from_options(cls, options: CoreOptions) -> "BucketRetryPolicy":
        return cls(
            max_attempts=options.get(
                CoreOptions.COMPACTION_RETRY_MAX_ATTEMPTS),
            backoff_base_ms=options.get(
                CoreOptions.COMPACTION_RETRY_BACKOFF),
            fallback=options.get(CoreOptions.COMPACTION_MESH_FALLBACK))

    def new_backoff(self):
        from paimon_tpu_torch.utils.backoff import Backoff
        return Backoff(self.backoff_base_ms, rng=self.rng)

    def retry_call(self, fn, *, on_retry=None):
        """Run `fn`: transient errors retry with backoff up to
        max_attempts attempts in all, then re-raise; others propagate at
        once.  Each backoff is recorded (flight recorder) and traced."""
        from paimon_tpu_torch.obs.flight import EV_RETRY, record
        from paimon_tpu_torch.obs.trace import span

        backoff = self.new_backoff()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except BaseException as e:      # noqa: BLE001
                if not is_transient_error(e) or \
                        attempt >= max(1, self.max_attempts):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                record(EV_RETRY, attempt=attempt, error=type(e).__name__)
                with span("retry.backoff", cat="compaction",
                          attempt=attempt, error=type(e).__name__):
                    backoff.pause()
