"""FileIO: the local file system.

Counterpart of paimon_tpu/fs/fileio.py reduced to the local file system
(the memory, object-store, caching and two-phase tiers are not ported
yet).  reference: paimon-common/.../fs/FileIO.java (SPI),
fs/local/LocalFileIO.java.  Paths are plain strings, optionally with a
``file://`` prefix.
"""

from __future__ import annotations

import os
import shutil
import uuid
from dataclasses import dataclass
from typing import List, Tuple

__all__ = ["FileIO", "FileStatus", "LocalFileIO", "get_file_io"]


@dataclass
class FileStatus:
    path: str
    size: int
    is_dir: bool
    mtime_ms: int = 0


class FileIO:
    """Abstract file IO. All paths are absolute strings."""

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        data = self.read_bytes(path)
        return data[offset:offset + length]

    def read_ranges(self, path: str,
                    ranges: List[Tuple[int, int]]) -> List[bytes]:
        """Vectored read: many (offset, length) ranges in one call
        (reference fs/VectoredReadable).  Default: one whole-file read,
        sliced."""
        data = self.read_bytes(path)
        return [bytes(data[o:o + ln]) for o, ln in ranges]

    def get_file_size(self, path: str) -> int:
        raise NotImplementedError

    def read_utf8(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8")

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list_status(self, path: str) -> List[FileStatus]:
        raise NotImplementedError

    def list_files(self, path: str) -> List[str]:
        return [s.path for s in self.list_status(path) if not s.is_dir]

    def write_bytes(self, path: str, data: bytes, overwrite: bool = True):
        raise NotImplementedError

    def write_utf8(self, path: str, text: str, overwrite: bool = True):
        self.write_bytes(path, text.encode("utf-8"), overwrite)

    def try_to_write_atomic(self, path: str, data: bytes) -> bool:
        """Atomically publish `data` at `path`; False if target exists.
        This is the commit CAS primitive (reference
        FileIO.tryToWriteAtomic); `data` must be writer-unique."""
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> bool:
        raise NotImplementedError

    def delete_quietly(self, path: str):
        try:
            self.delete(path, False)
        # best-effort cleanup of an abandoned attempt's files: its
        # failure must never fail the caller (an orphan is harmless)
        except OSError:
            pass


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

    def get_file_size(self, path: str) -> int:
        return os.path.getsize(self._strip(path))

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

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


_local = LocalFileIO()


def get_file_io(path: str) -> FileIO:
    """Resolve a FileIO by path scheme (reference fs/FileIOLoader)."""
    if "://" in path and not path.startswith("file://"):
        raise NotImplementedError(
            f"file system scheme {path.split('://', 1)[0]!r} is not ported "
            f"yet (ROADMAP.md: the remaining planes); local paths are")
    return _local
