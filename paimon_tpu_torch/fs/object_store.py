"""Object-store FileIO: commit semantics without rename(2).

Counterpart of paimon_tpu/fs/object_store.py; a bucket written by either
package is read by the other (the same key layout).  reference: paimon's object-store FileIOs (paimon-filesystems/ s3/oss/
gcs modules) differ from local filesystems in exactly the ways modeled
here — no atomic rename, flat keys instead of directories, LIST by
prefix, and conditional writes (If-None-Match: * / ETag preconditions)
as the only CAS primitive.  `ObjectStoreFileIO` adapts any
`ObjectStoreBackend` to the FileIO SPI:

- `try_to_write_atomic` = conditional PUT (the snapshot commit CAS) —
  no staging file + link(2) like LocalFileIO
- two-phase streams stage under a hidden key and publish with a
  conditional server-side copy, then delete the stage
- `mkdirs` is a no-op (keys are flat); directory listing derives from
  key prefixes

`LocalObjectStoreBackend` emulates a bucket on the local disk with the
same constraints (everything goes through put/get/list/head/delete +
preconditions, never rename), so the object-store commit path is fully
exercised in tests; a real S3/GCS backend only has to implement the
five backend calls.  No remote backend ships yet.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from paimon_tpu_torch.fs.fileio import (
    FileIO, FileStatus, TwoPhaseCommitter, TwoPhaseOutputStream,
)

__all__ = ["ObjectStoreBackend", "LocalObjectStoreBackend",
           "ObjectStoreFileIO", "FlakyObjectStoreBackend",
           "LatencyInjectingObjectStoreBackend",
           "RetryingObjectStoreBackend", "TransientStoreError",
           "CircuitOpenError"]


class PreconditionFailed(Exception):
    pass


class TransientStoreError(Exception):
    """A retryable server error (HTTP 503 / SlowDown / 500)."""


class CircuitOpenError(TransientStoreError):
    """The per-backend circuit breaker (fs/resilience.py) is OPEN: the
    store is known-sick and the call failed fast WITHOUT touching it.
    Subclasses TransientStoreError so the fault taxonomy still files
    it as transient, but `RetryingObjectStoreBackend` re-raises it
    immediately — retrying against an open circuit would just sleep
    through the breaker's whole point (fail fast, shed load)."""


class ObjectStoreBackend:
    """Five calls every real object store offers."""

    def put(self, key: str, data: bytes,
            if_none_match: bool = False) -> None:
        """if_none_match=True -> fail with PreconditionFailed when the
        key already exists (S3 If-None-Match: *, GCS
        x-goog-if-generation-match: 0)."""
        raise NotImplementedError

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def head(self, key: str) -> Optional[int]:
        """Size in bytes, or None when absent."""
        raise NotImplementedError

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        """[(key, size)] under prefix."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError


class LocalObjectStoreBackend(ObjectStoreBackend):
    """A 'bucket' on local disk with object-store semantics ONLY: flat
    keys (encoded to one directory level), no rename anywhere, and
    conditional PUT serialized by a lock (real stores serialize
    server-side)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # staging lives OUTSIDE the flat key namespace so in-flight or
        # orphaned temp writes can never appear in listings
        self._staging = os.path.join(root, ".staging")
        os.makedirs(self._staging, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        # flat namespace: escape separators so no directories exist
        return os.path.join(self.root, key.replace("/", "%2F"))

    def put(self, key: str, data: bytes,
            if_none_match: bool = False) -> None:
        with self._lock:
            p = self._path(key)
            if if_none_match and os.path.exists(p):
                raise PreconditionFailed(key)
            tmp = os.path.join(self._staging, uuid.uuid4().hex)
            with open(tmp, "wb") as f:
                f.write(data)
            # emulates the server's atomic object swap (not a FileIO
            # rename: this is inside the backend, like the store's own
            # internal commit)
            os.replace(tmp, p)

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        p = self._path(key)
        if not os.path.exists(p):
            raise FileNotFoundError(key)
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(length if length is not None else -1)

    def head(self, key: str) -> Optional[int]:
        p = self._path(key)
        return os.path.getsize(p) if os.path.exists(p) else None

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        enc = prefix.replace("/", "%2F")
        out = []
        for name in os.listdir(self.root):
            p = os.path.join(self.root, name)
            if name.startswith(enc) and os.path.isfile(p):
                out.append((name.replace("%2F", "/"),
                            os.path.getsize(p)))
        return sorted(out)

    def delete(self, key: str) -> bool:
        p = self._path(key)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False


class FlakyObjectStoreBackend(ObjectStoreBackend):
    """Fault-injecting wrapper modeling the two realities of a real
    store the plain emulation hides (VERDICT r3 weak #8):

    - **503 storms**: every call fails with TransientStoreError with
      probability `fail_rate` BEFORE taking effect, and mutations also
      fail with probability `ambiguous_rate` AFTER taking effect — the
      genuinely nasty case where the server applied the PUT but the
      client saw an error (S3 "SlowDown" mid-response), so a naive
      retry of a conditional PUT collides with its own write.
    - **eventually-consistent LIST**: a freshly PUT key stays invisible
      to `list()` for the next `list_lag` list calls (read-after-write
      on get/head stays strong — the pre-2020-S3 / OSS model).

    Deterministic under `seed` so failing schedules replay."""

    def __init__(self, inner: ObjectStoreBackend, seed: int = 0,
                 fail_rate: float = 0.0, ambiguous_rate: float = 0.0,
                 list_lag: int = 0):
        import random
        self.inner = inner
        self.rng = random.Random(seed)
        self.fail_rate = fail_rate
        self.ambiguous_rate = ambiguous_rate
        self.list_lag = list_lag
        self._list_calls = 0
        self._visible_after: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.stats = {"injected": 0, "ambiguous": 0, "lagged": 0}

    def _maybe_fail(self, op: str):
        with self._lock:
            if self.rng.random() < self.fail_rate:
                self.stats["injected"] += 1
                raise TransientStoreError(f"503 on {op}")

    def put(self, key: str, data: bytes, if_none_match: bool = False):
        self._maybe_fail(f"put {key}")
        # LIST lag applies only to keys that did not exist before: real
        # eventually-consistent stores may show a stale version of an
        # overwritten key in listings, but never its absence
        new_key = self.list_lag and self.inner.head(key) is None
        self.inner.put(key, data, if_none_match=if_none_match)
        with self._lock:
            if new_key:
                self._visible_after[key] = \
                    self._list_calls + self.list_lag
            if self.rng.random() < self.ambiguous_rate:
                self.stats["ambiguous"] += 1
                raise TransientStoreError(f"503 AFTER put {key}")

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        self._maybe_fail(f"get {key}")
        return self.inner.get(key, offset, length)

    def head(self, key: str) -> Optional[int]:
        self._maybe_fail(f"head {key}")
        return self.inner.head(key)

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        self._maybe_fail(f"list {prefix}")
        with self._lock:
            self._list_calls += 1
            calls = self._list_calls
            out = []
            for key, size in self.inner.list(prefix):
                if self._visible_after.get(key, 0) > calls:
                    self.stats["lagged"] += 1
                    continue
                out.append((key, size))
        return out

    def delete(self, key: str) -> bool:
        self._maybe_fail(f"delete {key}")
        ok = self.inner.delete(key)
        with self._lock:
            if self.rng.random() < self.ambiguous_rate:
                self.stats["ambiguous"] += 1
                raise TransientStoreError(f"503 AFTER delete {key}")
        return ok


class LatencyInjectingObjectStoreBackend(ObjectStoreBackend):
    """Latency-injecting wrapper: every backend call sleeps a
    configurable base + seeded jitter first, so benches and tests can
    model a REAL object store's per-request round trip (tens of ms)
    instead of local-disk timings — the difference the host-SSD cache
    tier and staged uploads exist to hide (benchmarks/tier_bench.py).

    `base_ms` is either one number for every op or a per-op dict keyed
    by 'put'/'get'/'head'/'list'/'delete' (missing ops pay 0, so e.g.
    only PUTs can be made slow).  Composable with
    FlakyObjectStoreBackend in either order: Flaky(Latency(store))
    charges the round trip before the 503 fires, like a real timeout.
    Thread-safe: the seeded rng is locked, sleeps happen outside.

    Chaos extensions (the tail-tolerance PR's injection surface —
    benchmarks/chaos_bench.py, tests/test_resilience.py):

    - **heavy tail**: with probability `tail_rate`, ops in `tail_ops`
      pay `tail_multiplier` x base instead of base — the "1% of GETs
      20x slow" shape hedged reads exist to beat.  When `pareto_alpha`
      is set the multiplier is drawn from a Pareto(alpha) distribution
      instead (a genuinely heavy tail: p99 >> p95 >> median, like real
      object-store stragglers).
    - **stuck requests**: with probability `stuck_rate`, the op HANGS
      for `stuck_ms` before proceeding — not an error, a stall.  No
      retry ladder fires; only a deadline-bounded wait (the resilient
      backend abandons the in-flight call) gets the caller out.

    The sleep is injectable (`sleep=`) so state-machine tests can run
    on a virtual clock."""

    def __init__(self, inner: ObjectStoreBackend, base_ms=10.0,
                 jitter_ms: float = 0.0, seed: int = 0,
                 tail_rate: float = 0.0, tail_multiplier: float = 20.0,
                 pareto_alpha: Optional[float] = None,
                 tail_ops: Tuple[str, ...] = ("get",),
                 stuck_rate: float = 0.0, stuck_ms: float = 0.0,
                 sleep=None):
        import random
        import time
        self.inner = inner
        self.base_ms = base_ms
        self.jitter_ms = jitter_ms
        self.tail_rate = tail_rate
        self.tail_multiplier = tail_multiplier
        self.pareto_alpha = pareto_alpha
        self.tail_ops = frozenset(tail_ops)
        self.stuck_rate = stuck_rate
        self.stuck_ms = stuck_ms
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.stats = {"delayed_calls": 0, "delay_ms_total": 0.0,
                      "tail_hits": 0, "stuck_hits": 0}

    def _delay(self, op: str):
        base = self.base_ms.get(op, 0.0) \
            if isinstance(self.base_ms, dict) else self.base_ms
        with self._lock:
            wait = base + (self._rng.random() * self.jitter_ms
                           if self.jitter_ms else 0.0)
            if op in self.tail_ops and self.tail_rate and \
                    self._rng.random() < self.tail_rate:
                mult = self._rng.paretovariate(self.pareto_alpha) \
                    if self.pareto_alpha is not None \
                    else self.tail_multiplier
                wait = base * mult
                self.stats["tail_hits"] += 1
            if self.stuck_rate and self._rng.random() < self.stuck_rate:
                wait += self.stuck_ms
                self.stats["stuck_hits"] += 1
            self.stats["delayed_calls"] += 1
            self.stats["delay_ms_total"] += wait
        if wait > 0:
            self._sleep(wait / 1000.0)

    def put(self, key: str, data: bytes, if_none_match: bool = False):
        self._delay("put")
        return self.inner.put(key, data, if_none_match=if_none_match)

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        self._delay("get")
        return self.inner.get(key, offset, length)

    def head(self, key: str) -> Optional[int]:
        self._delay("head")
        return self.inner.head(key)

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        self._delay("list")
        return self.inner.list(prefix)

    def delete(self, key: str) -> bool:
        self._delay("delete")
        return self.inner.delete(key)


class RetryingObjectStoreBackend(ObjectStoreBackend):
    """Client-side retry layer every real object-store FileIO carries
    (reference: hadoop-aws retry policies under the s3/oss FileIOs).
    Retries TransientStoreError with backoff; the ambiguous
    conditional-PUT case (error after effect) is resolved by read-back:
    if a retried If-None-Match PUT hits PreconditionFailed but the
    stored bytes equal ours, OUR write landed — report success.
    Snapshot JSON embeds commitUser uuid + millis, so byte-equality
    identifies the writer."""

    def __init__(self, inner: ObjectStoreBackend, max_attempts: int = 6,
                 backoff_s: float = 0.0,
                 backoff_cap_s: Optional[float] = None,
                 max_elapsed_s: Optional[float] = None,
                 rng=None):
        self.inner = inner
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.max_elapsed_s = max_elapsed_s
        self._rng = rng

    def _backoff(self):
        """Fresh capped decorrelated-jitter schedule per operation
        (utils/backoff.py — shared with FileStoreCommit's CAS retry
        wait and the mesh engine's per-bucket ladder)."""
        from paimon_tpu_torch.utils.backoff import Backoff
        return Backoff(
            self.backoff_s * 1000.0,
            None if self.backoff_cap_s is None
            else self.backoff_cap_s * 1000.0,
            None if self.max_elapsed_s is None
            else self.max_elapsed_s * 1000.0,
            rng=self._rng)

    def _retry(self, fn, op: str):
        last = None
        backoff = self._backoff()
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except CircuitOpenError:
                # the breaker below us says the store is sick: fail
                # fast instead of sleeping the whole ladder onto it —
                # the retry ladder consults breaker state BEFORE any
                # backoff wait (fs/resilience.py)
                raise
            except TransientStoreError as e:
                last = e
                if attempt + 1 >= self.max_attempts:
                    break               # terminal: no wait nobody uses
                if not backoff.pause():
                    raise TransientStoreError(
                        f"{op}: retry budget "
                        f"({self.max_elapsed_s}s) exhausted") from last
        raise TransientStoreError(
            f"{op}: {self.max_attempts} attempts exhausted") from last

    def put(self, key: str, data: bytes, if_none_match: bool = False):
        ambiguous = False
        last = None
        backoff = self._backoff()
        for attempt in range(self.max_attempts):
            try:
                return self.inner.put(key, data,
                                      if_none_match=if_none_match)
            except CircuitOpenError:
                raise               # fail fast: breaker open (see _retry)
            except TransientStoreError as e:
                last = e
                ambiguous = True       # effect may or may not be applied
                if attempt + 1 >= self.max_attempts:
                    break              # terminal: no wait nobody uses
                if not backoff.pause():
                    raise TransientStoreError(
                        f"put {key}: retry budget "
                        f"({self.max_elapsed_s}s) exhausted") from last
            except PreconditionFailed:
                if if_none_match and ambiguous:
                    # ambiguity resolution by read-back: valid ONLY
                    # because try_to_write_atomic payloads are
                    # writer-unique (FileIO contract) — snapshot JSON
                    # embeds commitUser uuid, lock files a random token
                    try:
                        if self.inner.get(key) == data:
                            return     # our own earlier attempt landed
                    except (FileNotFoundError, TransientStoreError):
                        continue
                raise
        raise TransientStoreError(
            f"put {key}: {self.max_attempts} attempts exhausted") \
            from last

    def get(self, key: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        return self._retry(lambda: self.inner.get(key, offset, length),
                           f"get {key}")

    def head(self, key: str) -> Optional[int]:
        return self._retry(lambda: self.inner.head(key), f"head {key}")

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        return self._retry(lambda: self.inner.list(prefix),
                           f"list {prefix}")

    def delete(self, key: str) -> bool:
        # delete is idempotent: a retry after an ambiguous error that
        # already applied just sees False (absent), which is the goal;
        # exhaustion raises like every other op so callers never
        # mistake a still-present key for a completed delete
        return self._retry(lambda: self.inner.delete(key),
                           f"delete {key}")


class ObjectStoreFileIO(FileIO):
    """FileIO over an ObjectStoreBackend (scheme e.g. 'objfs://')."""

    def __init__(self, backend: ObjectStoreBackend,
                 scheme: str = "objfs://"):
        self.backend = backend
        self.scheme = scheme

    def _key(self, path: str) -> str:
        if path.startswith(self.scheme):
            path = path[len(self.scheme):]
        return path.lstrip("/")

    # -- reads ---------------------------------------------------------------
    # every read checks the request deadline BEFORE its round trip: a
    # metadata walk (snapshot probes, manifest chain) is a sequence of
    # store ops with no other blocking wait between them, and on a
    # slow store each op can cost hundreds of ms — without this check
    # a timed-out request would ride the whole chain to completion.
    # The residual grace after a deadline trips is therefore bounded
    # by ONE op's latency (plus hedged ops abandon mid-call,
    # fs/resilience.py).  Writes deliberately have no check: their
    # cancellation points are the commit CAS gate and the durability
    # barriers, which own abort-vs-orphan semantics.

    @staticmethod
    def _check_deadline(what: str):
        from paimon_tpu_torch.utils.deadline import check_deadline
        check_deadline(what)

    def read_bytes(self, path: str) -> bytes:
        self._check_deadline("read")
        return self.backend.get(self._key(path))

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        self._check_deadline("read")
        return self.backend.get(self._key(path), offset, length)

    def read_ranges(self, path, ranges):
        # ranged GETs, one per range (real stores coalesce via HTTP
        # multi-range; the per-call shape is the same)
        key = self._key(path)
        out = []
        for o, ln in ranges:
            self._check_deadline("read")
            out.append(self.backend.get(key, o, ln))
        return out

    def exists(self, path: str) -> bool:
        self._check_deadline("exists")
        key = self._key(path)
        if self.backend.head(key) is not None:
            return True
        return bool(self.backend.list(key.rstrip("/") + "/"))

    def get_file_size(self, path: str) -> int:
        self._check_deadline("size")
        size = self.backend.head(self._key(path))
        if size is None:
            raise FileNotFoundError(path)
        return size

    def list_status(self, path: str) -> List[FileStatus]:
        self._check_deadline("list")
        prefix = self._key(path).rstrip("/") + "/"
        out: Dict[str, FileStatus] = {}
        for key, size in self.backend.list(prefix):
            rest = key[len(prefix):]
            if "/" in rest:               # synthetic directory entry
                child = prefix + rest.split("/", 1)[0]
                out.setdefault(child, FileStatus(
                    f"{self.scheme}{child}", 0, True))
            else:
                out[key] = FileStatus(f"{self.scheme}{key}", size, False)
        return sorted(out.values(), key=lambda s: s.path)

    # -- writes --------------------------------------------------------------

    def write_bytes(self, path: str, data: bytes, overwrite: bool = True):
        key = self._key(path)
        if not overwrite and self.backend.head(key) is not None:
            raise FileExistsError(path)
        self.backend.put(key, data)

    def try_to_write_atomic(self, path: str, data: bytes) -> bool:
        """THE commit CAS on object stores: conditional PUT, no rename
        (reference object-store SnapshotCommit implementations)."""
        try:
            self.backend.put(self._key(path), data, if_none_match=True)
            return True
        except PreconditionFailed:
            return False

    def new_two_phase_stream(self, path: str) -> TwoPhaseOutputStream:
        io_, final = self, path
        stage = (f"{path}.{uuid.uuid4().hex}.staging")
        parts: List[bytes] = []

        class S(TwoPhaseOutputStream):
            def write(self, data: bytes):
                parts.append(bytes(data))

            def close_for_commit(self) -> TwoPhaseCommitter:
                from paimon_tpu_torch.fs.fileio import reraise_with_path
                try:
                    # the part upload: close() is where the staged
                    # bytes actually hit the store, so a failure here
                    # must name the file it was for instead of the
                    # backend's generic error
                    io_.backend.put(io_._key(stage), b"".join(parts))
                except Exception as e:      # noqa: BLE001 — re-typed
                    reraise_with_path(e, final, "upload")

                class C(TwoPhaseCommitter):
                    def commit(self):
                        try:
                            blob = io_.backend.get(io_._key(stage))
                            io_.backend.put(io_._key(final), blob,
                                            if_none_match=True)
                        except PreconditionFailed:
                            io_.backend.delete(io_._key(stage))
                            raise FileExistsError(final)
                        except Exception as e:  # noqa: BLE001 — re-typed
                            reraise_with_path(e, final, "publish")
                        io_.backend.delete(io_._key(stage))

                    def discard(self):
                        io_.backend.delete(io_._key(stage))

                return C()

        return S()

    def mkdirs(self, path: str) -> bool:
        return True                        # flat keys: nothing to do

    def delete(self, path: str, recursive: bool = False) -> bool:
        key = self._key(path)
        ok = False
        if self.backend.head(key) is not None:
            ok = self.backend.delete(key)
        if recursive:
            # a key may exist BOTH as an object and as a prefix: drop
            # every child too
            for k, _ in self.backend.list(key.rstrip("/") + "/"):
                ok = self.backend.delete(k) or ok
        return ok

    def rename(self, src: str, dst: str) -> bool:
        # object stores have no rename: copy + delete per key
        # (non-atomic, which is exactly why commits use
        # try_to_write_atomic). Matches the FileIO contract: False when
        # src is absent or dst already exists; prefix (directory)
        # renames move every child key.
        skey, dkey = self._key(src), self._key(dst)
        if self.backend.head(dkey) is not None or                 self.backend.list(dkey.rstrip("/") + "/"):
            return False
        moved = False
        if self.backend.head(skey) is not None:
            self.backend.put(dkey, self.backend.get(skey))
            self.backend.delete(skey)
            moved = True
        prefix = skey.rstrip("/") + "/"
        for k, _ in self.backend.list(prefix):
            self.backend.put(dkey.rstrip("/") + "/" + k[len(prefix):],
                             self.backend.get(k))
            self.backend.delete(k)
            moved = True
        return moved

    def is_object_store(self) -> bool:
        return True
