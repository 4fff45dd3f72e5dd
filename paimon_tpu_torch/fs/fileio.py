"""FileIO implementations: the local file system, an in-memory one for
tests, and the scheme registry.

Counterpart of paimon_tpu/fs/fileio.py.  reference:
paimon-common/.../fs/FileIO.java (SPI), fs/local/LocalFileIO.java.
Paths are plain strings; a scheme prefix (``mem://``, ``file://``, one
registered with `register_file_io`, or none) selects the implementation
via `get_file_io`; an unregistered scheme raises ValueError.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

__all__ = ["FileIO", "FileStatus", "LocalFileIO", "MemoryFileIO",
           "get_file_io", "register_file_io", "safe_join"]


@dataclass
class FileStatus:
    path: str
    size: int
    is_dir: bool
    mtime_ms: int = 0


def safe_join(root: str, rel_path: str) -> str:
    """Join a user-supplied relative path under `root`, rejecting any
    traversal ('..', absolute paths) that would escape it."""
    rel = rel_path.lstrip("/")
    parts = [p for p in rel.split("/") if p not in ("", ".")]
    if any(p == ".." for p in parts):
        raise ValueError(f"Path escapes the root: {rel_path!r}")
    return f"{root.rstrip('/')}/{'/'.join(parts)}"


class FileIO:
    """Abstract file IO. All paths are absolute strings."""

    # -- reading -------------------------------------------------------------

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        data = self.read_bytes(path)
        return data[offset:offset + length]

    def read_ranges(self, path: str,
                    ranges: List[Tuple[int, int]]) -> List[bytes]:
        """Vectored read: many (offset, length) ranges in one call
        (reference fs/VectoredReadable — object stores coalesce these
        into ranged GETs; the local impl seeks within one open file).
        Default: one whole-file read, sliced."""
        data = self.read_bytes(path)
        return [bytes(data[o:o + ln]) for o, ln in ranges]

    # -- two-phase writes ----------------------------------------------------

    def new_two_phase_stream(self, path: str) -> "TwoPhaseOutputStream":
        """Write-then-publish stream: bytes go to an invisible staging
        location; `close_for_commit()` returns a committer whose
        commit() makes the file visible atomically and whose discard()
        leaves no trace (reference fs/TwoPhaseOutputStream.java,
        RenamingTwoPhaseOutputStream) — the building block for
        multi-file atomic operations."""
        return _BufferedTwoPhaseStream(self, path)

    def read_utf8(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8")

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def get_file_size(self, path: str) -> int:
        raise NotImplementedError

    def list_status(self, path: str) -> List[FileStatus]:
        raise NotImplementedError

    def list_files(self, path: str) -> List[str]:
        return [s.path for s in self.list_status(path) if not s.is_dir]

    def list_status_recursive(self, path: str) -> List["FileStatus"]:
        out: List[FileStatus] = []
        for st in self.list_status(path):
            if st.is_dir:
                out.extend(self.list_status_recursive(st.path))
            else:
                out.append(st)
        return out

    # -- writing -------------------------------------------------------------

    def write_bytes(self, path: str, data: bytes, overwrite: bool = True):
        raise NotImplementedError

    def write_utf8(self, path: str, text: str, overwrite: bool = True):
        self.write_bytes(path, text.encode("utf-8"), overwrite)

    def try_to_write_atomic(self, path: str, data: bytes) -> bool:
        """Atomically publish `data` at `path`; False if target exists.
        This is the commit CAS primitive (reference
        FileIO.tryToWriteAtomic).

        Contract: `data` must be writer-unique (snapshot JSON embeds
        commitUser uuid; lock files write a random token). On object
        stores, an ambiguous conditional PUT — server error after the
        write landed — is resolved by read-back content equality
        (RetryingObjectStoreBackend), which requires that byte-equal
        means same-writer (or that the operation is idempotent so a
        false positive is harmless)."""
        raise NotImplementedError

    def mkdirs(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> bool:
        raise NotImplementedError

    def delete_quietly(self, path: str):
        # shielded from the request deadline: quiet deletes are the
        # abort/cleanup contract and run exactly when the deadline is
        # already spent — unshielded, the deadline check inside the
        # store op would raise, be swallowed here, and orphan the very
        # file this cleanup exists to remove (utils/deadline.py)
        from paimon_tpu_torch.utils.deadline import deadline_shield
        try:
            with deadline_shield():
                self.delete(path, False)
        # lint-ok: swallow quiet delete IS the two-phase-commit
        # cleanup contract: best-effort removal whose failure must
        # never fail the caller (fsck collects any orphan later)
        except Exception:
            pass

    def rename(self, src: str, dst: str) -> bool:
        raise NotImplementedError

    def copy(self, src: str, dst: str, overwrite: bool = True):
        self.write_bytes(dst, self.read_bytes(src), overwrite)

    # -- helpers -------------------------------------------------------------

    def is_object_store(self) -> bool:
        return False


def reraise_with_path(e: BaseException, path: str, phase: str):
    """Re-raise `e` as the same exception type with the destination
    path in the message.  A failed part upload inside a two-phase
    stream otherwise surfaces a backend-generic error ("disk full",
    bare errno) with no file context — the caller staging dozens of
    files cannot tell WHICH upload died.  Exception types whose
    constructor rejects a single message fall back to the original."""
    try:
        wrapped = type(e)(f"two-phase {phase} for {path} failed: {e}")
    except Exception:
        raise e
    raise wrapped from e


class TwoPhaseOutputStream:
    """write() bytes, then close_for_commit() -> Committer.

    Contract: `close_for_commit()` performs (or completes) the staging
    upload — any upload failure it raises names the destination path
    in the exception message (see `reraise_with_path`)."""

    def write(self, data: bytes):
        raise NotImplementedError

    def close_for_commit(self) -> "TwoPhaseCommitter":
        raise NotImplementedError


class TwoPhaseCommitter:
    def commit(self):
        raise NotImplementedError

    def discard(self):
        raise NotImplementedError


class _BufferedTwoPhaseStream(TwoPhaseOutputStream):
    """Generic fallback: buffer in memory, publish via
    try_to_write_atomic on commit."""

    def __init__(self, file_io: "FileIO", path: str):
        self._io = file_io
        self._path = path
        self._parts: List[bytes] = []

    def write(self, data: bytes):
        self._parts.append(bytes(data))

    def close_for_commit(self) -> TwoPhaseCommitter:
        io_, path, blob = self._io, self._path, b"".join(self._parts)
        self._parts = []

        class C(TwoPhaseCommitter):
            def commit(self):
                try:
                    ok = io_.try_to_write_atomic(path, blob)
                except FileExistsError:
                    raise
                except Exception as e:      # noqa: BLE001 — re-typed
                    reraise_with_path(e, path, "publish")
                if not ok:
                    raise FileExistsError(path)

            def discard(self):
                pass

        return C()


class LocalFileIO(FileIO):
    """Local filesystem (reference fs/local/LocalFileIO.java)."""

    @staticmethod
    def _strip(path: str) -> str:
        if path.startswith("file://"):
            return path[len("file://"):]
        return path

    def read_bytes(self, path: str) -> bytes:
        with open(self._strip(path), "rb") as f:
            return f.read()

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(self._strip(path), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def read_ranges(self, path: str,
                    ranges: List[Tuple[int, int]]) -> List[bytes]:
        """One open, N seeks — never the whole file."""
        out = []
        with open(self._strip(path), "rb") as f:
            for offset, length in ranges:
                f.seek(offset)
                out.append(f.read(length))
        return out

    def new_two_phase_stream(self, path: str) -> "TwoPhaseOutputStream":
        return _LocalTwoPhaseStream(self, path)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def get_file_size(self, path: str) -> int:
        return os.path.getsize(self._strip(path))

    def list_status(self, path: str) -> List[FileStatus]:
        p = self._strip(path)
        if not os.path.isdir(p):
            return []
        out = []
        for name in os.listdir(p):
            full = os.path.join(p, name)
            try:
                st = os.stat(full)
            except FileNotFoundError:
                # raced a concurrent writer/deleter: atomic-write .tmp
                # files and expiring snapshots vanish between listdir
                # and stat — a listing reflects SOME point in time
                continue
            out.append(FileStatus(full, st.st_size, os.path.isdir(full),
                                  int(st.st_mtime * 1000)))
        return out

    def write_bytes(self, path: str, data: bytes, overwrite: bool = True):
        p = self._strip(path)
        if not overwrite and os.path.exists(p):
            raise FileExistsError(p)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    def try_to_write_atomic(self, path: str, data: bytes) -> bool:
        p = self._strip(path)
        if os.path.exists(p):
            return False
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + "." + uuid.uuid4().hex + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            # On POSIX link() fails if the target exists -> CAS semantics
            # (rename() would silently overwrite).
            try:
                os.link(tmp, p)
                return True
            except FileExistsError:
                return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def mkdirs(self, path: str) -> bool:
        os.makedirs(self._strip(path), exist_ok=True)
        return True

    def delete(self, path: str, recursive: bool = False) -> bool:
        p = self._strip(path)
        if not os.path.exists(p):
            return False
        if os.path.isdir(p):
            if recursive:
                shutil.rmtree(p)
            else:
                os.rmdir(p)
        else:
            os.remove(p)
        return True

    def rename(self, src: str, dst: str) -> bool:
        s, d = self._strip(src), self._strip(dst)
        if os.path.exists(d):
            return False
        os.makedirs(os.path.dirname(d), exist_ok=True)
        try:
            os.rename(s, d)
            return True
        except OSError:
            return False


class _LocalTwoPhaseStream(TwoPhaseOutputStream):
    """Stage in a hidden sibling file, fsync'd, published by rename
    (reference fs/RenamingTwoPhaseOutputStream.java)."""

    def __init__(self, file_io: "LocalFileIO", path: str):
        import uuid as _uuid
        self._io = file_io
        self._final = file_io._strip(path)
        os.makedirs(os.path.dirname(self._final), exist_ok=True)
        self._tmp = os.path.join(
            os.path.dirname(self._final),
            f".{os.path.basename(self._final)}."
            f"{_uuid.uuid4().hex}.inprogress")
        self._f = open(self._tmp, "wb")

    def write(self, data: bytes):
        self._f.write(data)

    def close_for_commit(self) -> TwoPhaseCommitter:
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        except OSError as e:
            # a torn staging write names the FINAL path it was for,
            # not just the hidden .inprogress temp
            reraise_with_path(e, self._final, "staging write")
        tmp, final = self._tmp, self._final

        class C(TwoPhaseCommitter):
            def commit(self):
                # link(2) fails with EEXIST instead of silently
                # overwriting like rename(2) — the same CAS primitive
                # try_to_write_atomic uses
                try:
                    os.link(tmp, final)
                except FileExistsError:
                    os.remove(tmp)
                    raise FileExistsError(final)
                os.remove(tmp)

            def discard(self):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

        return C()


class MemoryFileIO(FileIO):
    """In-memory FileIO for tests (role of reference test LocalFileIO usage +
    TraceableFileIO). One shared namespace per instance."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._lock = threading.RLock()

    @staticmethod
    def _strip(path: str) -> str:
        if path.startswith("mem://"):
            return path[len("mem://"):]
        return path

    def read_bytes(self, path: str) -> bytes:
        with self._lock:
            p = self._strip(path)
            if p not in self._files:
                raise FileNotFoundError(path)
            return self._files[p]

    def exists(self, path: str) -> bool:
        with self._lock:
            p = self._strip(path)
            if p in self._files:
                return True
            prefix = p.rstrip("/") + "/"
            return any(k.startswith(prefix) for k in self._files)

    def get_file_size(self, path: str) -> int:
        return len(self.read_bytes(path))

    def list_status(self, path: str) -> List[FileStatus]:
        with self._lock:
            prefix = self._strip(path).rstrip("/") + "/"
            seen = {}
            for k, v in self._files.items():
                if not k.startswith(prefix):
                    continue
                rest = k[len(prefix):]
                if "/" in rest:
                    d = prefix + rest.split("/", 1)[0]
                    seen[d] = FileStatus(d, 0, True)
                else:
                    seen[k] = FileStatus(k, len(v), False)
            return list(seen.values())

    def write_bytes(self, path: str, data: bytes, overwrite: bool = True):
        with self._lock:
            p = self._strip(path)
            if not overwrite and p in self._files:
                raise FileExistsError(path)
            self._files[p] = bytes(data)

    def try_to_write_atomic(self, path: str, data: bytes) -> bool:
        with self._lock:
            p = self._strip(path)
            if p in self._files:
                return False
            self._files[p] = bytes(data)
            return True

    def mkdirs(self, path: str) -> bool:
        return True

    def delete(self, path: str, recursive: bool = False) -> bool:
        with self._lock:
            p = self._strip(path)
            if p in self._files:
                del self._files[p]
                return True
            if recursive:
                prefix = p.rstrip("/") + "/"
                keys = [k for k in self._files if k.startswith(prefix)]
                for k in keys:
                    del self._files[k]
                return bool(keys)
            return False

    def rename(self, src: str, dst: str) -> bool:
        with self._lock:
            s, d = self._strip(src), self._strip(dst)
            if d in self._files or s not in self._files:
                return False
            self._files[d] = self._files.pop(s)
            return True

    def is_object_store(self) -> bool:
        return False


_REGISTRY: Dict[str, Callable[[], FileIO]] = {}
_local = LocalFileIO()


def register_file_io(scheme: str, factory: Callable[[], FileIO]):
    _REGISTRY[scheme] = factory


def get_file_io(path: str) -> FileIO:
    """Resolve a FileIO by path scheme (reference fs/FileIOLoader)."""
    if "://" in path:
        scheme = path.split("://", 1)[0]
        if scheme == "file":
            return _local
        if scheme in _REGISTRY:
            return _REGISTRY[scheme]()
        raise ValueError(f"No FileIO registered for scheme {scheme!r}")
    return _local
