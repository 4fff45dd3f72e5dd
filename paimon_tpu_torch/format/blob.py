"""Blob storage: large binary columns externalized to .blob sidecars.

Counterpart of paimon_tpu/format/blob.py (the same sidecar bytes and
descriptor structs).  reference: paimon-format/.../blob/BlobFileFormat.java (length-prefixed
binary elements), data/BlobDescriptor.java (pointer stored in the data
file), blob/ externalization in paimon-core.

Wire shape: the data file stores a struct<offset: int64, length: int64>
per row (null = null blob) pointing into `<data-file>.blob`, which holds
the concatenated raw values. The sidecar rides extra_files so expiry /
orphan cleanup track it with the data file.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa

from paimon_tpu_torch.types import BlobType

__all__ = ["DESCRIPTOR_TYPE", "externalize_blobs", "resolve_blobs",
           "maybe_resolve_blobs", "blob_column_names",
           "blob_sidecar_name"]


def blob_column_names(schema) -> List[str]:
    """Blob-typed field names of a TableSchema (single source of truth
    for blob detection)."""
    return [f.name for f in schema.fields if isinstance(f.type, BlobType)]

DESCRIPTOR_TYPE = pa.struct([pa.field("offset", pa.int64()),
                             pa.field("length", pa.int64())])


def blob_sidecar_name(data_file_name: str) -> str:
    return data_file_name + ".blob"


def externalize_blobs(file_io, path_factory, partition, bucket,
                      data_file_name: str, chunk: pa.Table,
                      blob_columns: List[str]
                      ) -> Tuple[pa.Table, List[str]]:
    """Replace blob columns with descriptor structs; write one sidecar
    holding all the chunk's blob bytes. -> (chunk', extra_files)."""
    cols = [c for c in blob_columns if c in chunk.column_names]
    if not cols:
        return chunk, []
    payload_parts: List[bytes] = []
    payload_len = 0
    out = chunk
    for name in cols:
        arr = out.column(name).combine_chunks().cast(pa.large_binary())
        # zero-copy: arrow binary arrays already hold a contiguous value
        # buffer + offsets; slice buffers instead of per-row pylists
        buf_offsets = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                                    count=len(arr) + 1, offset=0)
        data_buf = arr.buffers()[2]
        raw = bytes(data_buf) if data_buf is not None else b""
        null_mask = np.asarray(arr.is_null())
        lengths = (buf_offsets[1:] - buf_offsets[:-1]).astype(np.int64)
        starts = buf_offsets[:-1] + 0
        offsets_out = starts + payload_len
        payload_parts.append(raw)
        payload_len += len(raw)
        desc = pa.StructArray.from_arrays(
            [pa.array(offsets_out, pa.int64()),
             pa.array(lengths, pa.int64())],
            fields=list(DESCRIPTOR_TYPE),
            mask=pa.array(null_mask))
        out = out.set_column(out.column_names.index(name), name, desc)
    payload = b"".join(payload_parts)
    if not payload:
        return out, []
    sidecar = blob_sidecar_name(data_file_name)
    file_io.write_bytes(
        path_factory.data_file_path(partition, bucket, sidecar),
        payload, overwrite=False)
    return out, [sidecar]


def resolve_blobs(file_io, path_factory, partition, bucket,
                  meta, table: pa.Table,
                  blob_columns: List[str]) -> pa.Table:
    """Inverse of externalize_blobs: descriptor structs -> binary."""
    cols = [c for c in blob_columns
            if c in table.column_names
            and pa.types.is_struct(table.column(c).type)]
    if not cols:
        return table
    sidecar = next((x for x in meta.extra_files if x.endswith(".blob")),
                   None)
    data = b""
    if sidecar is not None:
        data = file_io.read_bytes(
            path_factory.data_file_path(partition, bucket, sidecar))
    for name in cols:
        arr = table.column(name).combine_chunks()
        values = _contiguous_values(arr, data)
        if values is None:
            offsets = arr.field("offset").to_pylist()
            lengths = arr.field("length").to_pylist()
            values = pa.array([None if o is None else data[o:o + ln]
                               for o, ln in zip(offsets, lengths)],
                              pa.binary())
        table = table.set_column(table.column_names.index(name), name,
                                 values)
    return table


def _contiguous_values(arr: pa.StructArray, data: bytes
                       ) -> Optional[pa.Array]:
    """The binary column `arr`'s descriptors point at, built over the
    sidecar's bytes without a copy, when the rows' byte ranges follow
    one another (as externalize_blobs lays out one column); None
    otherwise.  A row is null where its offset is, as in the
    row-by-row path."""
    offset, length = arr.field("offset"), arr.field("length")
    n = len(arr)
    valid = ~np.asarray(offset.is_null()) if offset.null_count \
        else np.ones(n, dtype=bool)
    if not valid.any() or \
            np.asarray(length.is_null())[valid].any():
        return None
    o = np.asarray(offset.fill_null(0).to_numpy(), dtype=np.int64)
    ln = np.where(valid, np.asarray(length.fill_null(0).to_numpy(),
                                    dtype=np.int64), 0)
    vo, vl = o[valid], ln[valid]
    if (vl < 0).any() or vo[0] < 0 or \
            not np.array_equal(vo[1:], vo[:-1] + vl[:-1]) or \
            vo[-1] + vl[-1] > len(data) or vo[-1] + vl[-1] >= 1 << 31:
        return None
    offsets = np.empty(n + 1, dtype=np.int32)
    offsets[0] = vo[0]
    np.cumsum(ln, out=offsets[1:])
    offsets[1:] += vo[0]
    nulls = n - int(valid.sum())
    bitmap = pa.py_buffer(np.packbits(valid, bitorder="little")) \
        if nulls else None
    return pa.Array.from_buffers(
        pa.binary(), n, [bitmap, pa.py_buffer(offsets), pa.py_buffer(data)],
        null_count=nulls)


def maybe_resolve_blobs(file_io, path_factory, partition, bucket, meta,
                        table: pa.Table, schema, schema_manager=None,
                        wanted=None) -> pa.Table:
    """Schema-aware resolve. Blob columns come from the FILE's schema
    (meta.schema_id) so renames never orphan descriptors; columns outside
    `wanted` (a projection) are dropped instead of resolved — no sidecar
    read when the projection excludes every blob column."""
    file_schema = schema
    if meta.schema_id != schema.id and schema_manager is not None:
        try:
            file_schema = schema_manager.schema(meta.schema_id)
        except Exception:
            file_schema = schema
    blob_cols = [c for c in blob_column_names(file_schema)
                 if c in table.column_names]
    if not blob_cols:
        return table
    if wanted is not None:
        # the projection names columns in the CURRENT schema; map the
        # file's blob columns forward by field id before filtering
        file_id = {f.name: f.id for f in file_schema.fields}
        cur_name = {f.id: f.name for f in schema.fields}

        def current_name(c):
            return cur_name.get(file_id.get(c), c)

        skip = [c for c in blob_cols if current_name(c) not in wanted]
        if skip:
            table = table.drop_columns(skip)
            blob_cols = [c for c in blob_cols if c not in skip]
        if not blob_cols:
            return table
    return resolve_blobs(file_io, path_factory, partition, bucket, meta,
                         table, blob_cols)
