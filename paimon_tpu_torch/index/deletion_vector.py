"""Deletion vectors: per-file bitmaps of deleted row positions,
wire-compatible with the reference.

Counterpart of paimon_tpu/index/deletion_vector.py: the index files are
the reference's byte for byte (the same roaring bytes, CRC and ranges).

reference: paimon-core/.../deletionvectors/BitmapDeletionVector.java
(RoaringBitmap32 + MAGIC 1581511376), DeletionVectorsIndexFile.java
(VERSION byte 1, then per DV: [i32 BE length][i32 BE magic][roaring
bytes][i32 BE crc32]; index manifest records (offset, length,
cardinality) per data file).

In memory the positions live as a sorted numpy array: the apply path
(mask rows during the scan) is a vectorised mask, and roaring is only
the wire format.
"""

from __future__ import annotations

import struct
import uuid
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.index.roaring import (
    deserialize_roaring32, serialize_roaring32,
)

__all__ = ["DeletionVector", "DeletionVectorsIndexFile",
           "read_deletion_vectors"]

MAGIC_V1 = 1581511376
VERSION_V1 = 1


class DeletionVector:
    """Sorted set of deleted row positions within one data file."""

    def __init__(self, positions: Optional[np.ndarray] = None):
        if positions is None:
            positions = np.zeros(0, dtype=np.int64)
        self.positions = np.unique(np.asarray(positions, dtype=np.int64))

    def delete(self, pos: int):
        self.positions = np.unique(np.append(self.positions, pos))

    def merge(self, other: "DeletionVector") -> "DeletionVector":
        return DeletionVector(np.concatenate([self.positions,
                                              other.positions]))

    def is_deleted(self, pos: int) -> bool:
        i = np.searchsorted(self.positions, pos)
        return bool(i < len(self.positions) and self.positions[i] == pos)

    def cardinality(self) -> int:
        return len(self.positions)

    def is_empty(self) -> bool:
        return len(self.positions) == 0

    def keep_mask(self, num_rows: int) -> np.ndarray:
        """bool[num_rows], False where deleted -- vectorized apply
        (role of reference ApplyDeletionVectorReader)."""
        mask = np.ones(num_rows, dtype=bool)
        valid = self.positions[(self.positions >= 0)
                               & (self.positions < num_rows)]
        mask[valid] = False
        return mask

    # -- wire format (reference BitmapDeletionVector.serializeTo) ------------

    def serialize(self) -> bytes:
        """[i32 BE length][i32 BE MAGIC + roaring bytes][i32 BE crc32]."""
        # int64 positions pass through unchanged: the roaring codec
        # raises on values beyond the 32-bit range instead of wrapping
        body = struct.pack(">i", MAGIC_V1) + \
            serialize_roaring32(self.positions)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return struct.pack(">i", len(body)) + body + struct.pack(">I", crc)

    @staticmethod
    def deserialize(data: bytes) -> "DeletionVector":
        (length,) = struct.unpack_from(">i", data, 0)
        (magic,) = struct.unpack_from(">i", data, 4)
        if magic != MAGIC_V1:
            raise ValueError(f"Invalid deletion vector magic {magic}")
        body = data[4:4 + length]
        if len(data) >= 4 + length + 4:
            (crc,) = struct.unpack_from(">I", data, 4 + length)
            actual = zlib.crc32(body) & 0xFFFFFFFF
            if crc != actual:
                raise ValueError(
                    f"Deletion vector checksum mismatch "
                    f"(stored {crc}, computed {actual})")
        positions = deserialize_roaring32(body[4:])
        return DeletionVector(positions.astype(np.int64))


class DeletionVectorsIndexFile:
    """Packs several files' DVs into one index file; ranges recorded in the
    index manifest (reference DeletionVectorsIndexFile.java)."""

    def __init__(self, file_io: FileIO, index_dir: str):
        self.file_io = file_io
        self.index_dir = index_dir.rstrip("/")

    def write(self, dvs: Dict[str, DeletionVector],
              name: Optional[str] = None,
              path_factory=None
              ) -> Tuple[str, int, Dict[str, Tuple[int, int, int]]]:
        """-> (file_name, file_size, ranges {data_file: (offset, len,
        cardinality)}). Layout: VERSION byte then DV entries; offsets
        point at each entry's length field, length covers magic+bitmap
        (reference DeletionVectorMeta semantics)."""
        if name is None:
            name = path_factory.new_index_file_name() if path_factory \
                else f"index-{uuid.uuid4()}-0"
        blobs = [bytes([VERSION_V1])]
        ranges: Dict[str, Tuple[int, int, int]] = {}
        offset = 1
        for data_file, dv in dvs.items():
            blob = dv.serialize()
            # recorded length excludes the 4-byte length prefix and crc
            ranges[data_file] = (offset, len(blob) - 8, dv.cardinality())
            blobs.append(blob)
            offset += len(blob)
        payload = b"".join(blobs)
        path = f"{self.index_dir}/{name}"
        self.file_io.write_bytes(path, payload, overwrite=False)
        return name, len(payload), ranges

    def read(self, name: str,
             ranges: Dict[str, Tuple[int, int, int]]
             ) -> Dict[str, DeletionVector]:
        return read_deletion_vectors(
            self.file_io, f"{self.index_dir}/{name}", ranges)


def read_deletion_vectors(file_io: FileIO, index_path: str,
                          ranges: Dict[str, Tuple[int, int, int]]
                          ) -> Dict[str, DeletionVector]:
    data = file_io.read_bytes(index_path)
    if data[:1] != bytes([VERSION_V1]):
        raise ValueError(f"Unknown DV index version {data[:1]!r}")
    out = {}
    for f, (off, ln, _) in ranges.items():
        out[f] = DeletionVector.deserialize(data[off:off + ln + 8])
    return out
