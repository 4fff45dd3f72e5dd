"""Write-side staging FileIO: data-file writes land on a local disk
first, upload asynchronously, and stay readable throughout.

Counterpart of paimon_tpu/fs/staging.py ("A Host-SSD Collaborative
Write Accelerator for LSM-Tree-Based KV Stores", arxiv 2410.21760: the
host disk absorbs the store's per-PUT round trip, so the flush
pipeline's critical path runs at local-disk speed).  Only
immutable-named, overwrite=False writes stage (data, changelog and
index files); the upload itself belongs to the UploadStager's pool
(parallel/write_pipeline.py).  Mutable refs, manifests and the commit
CAS never pass through a StagingFileIO: writers wrap their own FileIO,
while FileStoreCommit keeps the table's.  Reads, existence and size
checks consult the pending staged files first, so compaction inside
prepare_commit can re-read a just-flushed L0 file before its upload
lands; everything else delegates.

Durability: `UploadStager.drain()` runs at the end of prepare_commit(),
so no commit message leaves the writer before every file it names is
acked by the store, as on the inline-upload path.
"""

from __future__ import annotations

from typing import List, Tuple

from paimon_tpu_torch.fs.fileio import FileIO

__all__ = ["StagingFileIO"]


class StagingFileIO(FileIO):
    """FileIO wrapper routing immutable data-file writes through an
    UploadStager (stage locally, upload asynchronously) and serving
    reads of in-flight paths from the staged bytes."""

    def __init__(self, inner: FileIO, stager):
        self.inner = inner
        self.stager = stager

    # -- staged writes -------------------------------------------------------

    def write_bytes(self, path: str, data: bytes, overwrite: bool = True):
        if overwrite or not self.stager.accepts(path):
            # mutable refs and overwriting writes keep synchronous store
            # semantics: staging is only for write-once data files
            return self.inner.write_bytes(path, data, overwrite=overwrite)
        self.stager.stage(self.inner, path, data)

    # -- reads: pending staged files first -----------------------------------

    def read_bytes(self, path: str) -> bytes:
        data = self.stager.pending_bytes(path)
        if data is not None:
            return data
        return self.inner.read_bytes(path)

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        data = self.stager.pending_bytes(path)
        if data is not None:
            return data[offset:offset + length]
        return self.inner.read_range(path, offset, length)

    def read_ranges(self, path: str,
                    ranges: List[Tuple[int, int]]) -> List[bytes]:
        data = self.stager.pending_bytes(path)
        if data is not None:
            return [bytes(data[o:o + ln]) for o, ln in ranges]
        return self.inner.read_ranges(path, ranges)

    def exists(self, path: str) -> bool:
        if self.stager.pending_size(path) is not None:
            return True
        return self.inner.exists(path)

    def get_file_size(self, path: str) -> int:
        size = self.stager.pending_size(path)
        if size is not None:
            return size
        return self.inner.get_file_size(path)

    # -- delegation ----------------------------------------------------------

    def try_to_write_atomic(self, path: str, data: bytes) -> bool:
        return self.inner.try_to_write_atomic(path, data)

    def list_status(self, path: str):
        return self.inner.list_status(path)

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self.inner.delete(path, recursive=recursive)

    def rename(self, src: str, dst: str) -> bool:
        return self.inner.rename(src, dst)

    def __getattr__(self, name):
        # helpers a concrete FileIO adds (mkdirs, copy, ...) delegate
        return getattr(self.inner, name)
