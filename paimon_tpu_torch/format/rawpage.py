"""Raw Parquet page reader: undecoded column chunks -> device decode.

Counterpart of paimon_tpu/format/rawpage.py.  The parquet footer
(cached process-wide, fs/caching.py) locates each column chunk, the
chunk's raw bytes come through ``FileIO.read_ranges``, and the host
work left is page-header and run-header parsing (a few thrift varints
per page) and codec decompression.  Every per-value transform runs as
torch ops (ops/decode.py) on the caller's device, one column chunk at a
time:

1. host: walk the chunk's pages, decompress them, parse the
   definition-level and dictionary-index run headers, and lay every
   page's level stream, index stream, PLAIN values, the dictionary and
   one int64 table of runs and pages out in one buffer (a whole file's
   chunks are planned by a pool of threads, ahead of the device work);
2. upload that buffer once;
3. expand levels, indices, the dictionary gather, PLAIN values and
   nulls for the whole chunk on the device;
4. download the values (and the validity, where a value is null) once.

Coverage is the hot-path subset of the reference: flat columns,
physical INT32/INT64/FLOAT/DOUBLE, v1 data pages, PLAIN and
RLE/PLAIN-dictionary value encodings, RLE definition levels,
UNCOMPRESSED/SNAPPY/GZIP/ZSTD codecs.  Anything else raises
``DeviceDecodeUnsupported``; ``maybe_read_device`` and the streamed
iterator then take the pyarrow host path and count the fallback in
``DECODE_COUNTS``.  The caught errors never include RuntimeError: on a
CUDA device a bad index is a device-side assert, which surfaces.
"""

from __future__ import annotations

import io
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.fs import FileIO

__all__ = ["DeviceDecodeUnsupported", "read_parquet_device",
           "maybe_read_device", "iter_batches_device",
           "maybe_iter_batches_device",
           "device_decode_supported", "parse_page_header", "parse_rle_runs",
           "DECODE_COUNTS"]

# files read through the device decode plane, and files (or the rest of
# a file, in the streamed iterator) that fell back to pyarrow
DECODE_COUNTS = {"files": 0, "fallbacks": 0}
_COUNT_LOCK = threading.Lock()


def _count(key: str) -> None:
    with _COUNT_LOCK:
        DECODE_COUNTS[key] += 1


# parquet-format enums (format/src/main/thrift/parquet.thrift)
_ENC_PLAIN = 0
_ENC_PLAIN_DICT = 2
_ENC_RLE = 3
_ENC_RLE_DICT = 8
_PAGE_DATA = 0
_PAGE_DICT = 2
_PAGE_DATA_V2 = 3

_PHYS_WIDTH = {"INT32": 4, "INT64": 8, "FLOAT": 4, "DOUBLE": 8}
_CODECS = {"UNCOMPRESSED", "SNAPPY", "GZIP", "ZSTD"}
# threads that plan one file's column chunks on the host
_PLAN_THREADS = 8
# footer-declared chunk encodings inside coverage; anything else
# falls back from the footer alone, before any data byte is fetched
_ENCODINGS = {"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY"}


class DeviceDecodeUnsupported(Exception):
    """This file or column needs an encoding, codec or shape outside
    the device decode plane's coverage; the caller takes the pyarrow
    host path."""


# ---------------------------------------------------------------------------
# thrift compact protocol (page headers only; footers come from pyarrow)
# ---------------------------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(buf, pos: int) -> Tuple[int, int]:
    v, pos = _varint(buf, pos)
    return (v >> 1) ^ -(v & 1), pos


def _skip(buf, pos: int, ftype: int) -> int:
    if ftype in (1, 2):                       # bool encoded in header
        return pos
    if ftype == 3:                            # i8
        return pos + 1
    if ftype in (4, 5, 6):                    # i16/i32/i64 zigzag
        return _zigzag(buf, pos)[1]
    if ftype == 7:                            # double
        return pos + 8
    if ftype == 8:                            # binary
        ln, pos = _varint(buf, pos)
        return pos + ln
    if ftype in (9, 10):                      # list/set
        head = buf[pos]
        pos += 1
        size, etype = head >> 4, head & 0x0F
        if size == 0x0F:
            size, pos = _varint(buf, pos)
        for _ in range(size):
            pos = _skip(buf, pos, etype)
        return pos
    if ftype == 11:                           # map
        size, pos = _varint(buf, pos)
        if size == 0:
            return pos
        kv = buf[pos]
        pos += 1
        for _ in range(size):
            pos = _skip(buf, pos, kv >> 4)
            pos = _skip(buf, pos, kv & 0x0F)
        return pos
    if ftype == 12:                           # struct
        _, pos = _compact_struct(buf, pos, keep=())
        return pos
    raise DeviceDecodeUnsupported(f"thrift compact type {ftype}")


def _compact_struct(buf, pos: int, keep: Sequence[int],
                    structs: Optional[Dict[int, Sequence[int]]] = None,
                    ) -> Tuple[Dict[int, object], int]:
    """Walk one compact-protocol struct, returning {field id: value}
    for scalar fields in `keep` and nested structs in `structs`
    (field id -> that struct's keep list); everything else is skipped."""
    structs = structs or {}
    out: Dict[int, object] = {}
    fid = 0
    while True:
        head = buf[pos]
        pos += 1
        if head == 0:
            return out, pos
        delta = head >> 4
        ftype = head & 0x0F
        if delta:
            fid += delta
        else:
            fid, pos = _zigzag(buf, pos)
        if ftype in (1, 2):
            if fid in keep:
                out[fid] = ftype == 1
            continue
        if fid in structs and ftype == 12:
            out[fid], pos = _compact_struct(buf, pos, keep=structs[fid])
            continue
        if fid in keep and ftype in (4, 5, 6):
            v, pos = _zigzag(buf, pos)
            out[fid] = v
            continue
        pos = _skip(buf, pos, ftype)


def parse_page_header(buf, pos: int) -> Tuple[Dict, int]:
    """Parse one thrift-compact PageHeader at `pos`; returns (header
    dict, payload start)."""
    fields, pos = _compact_struct(
        buf, pos, keep=(1, 2, 3),
        structs={5: (1, 2, 3, 4),       # DataPageHeader
                 7: (1, 2, 3),          # DictionaryPageHeader
                 8: (1, 2, 3, 4, 5, 6, 7)})   # DataPageHeaderV2
    return {
        "type": fields.get(1),
        "uncompressed_size": fields.get(2),
        "compressed_size": fields.get(3),
        "data": fields.get(5),
        "dict": fields.get(7),
        "data_v2": fields.get(8),
    }, pos


# ---------------------------------------------------------------------------
# RLE/bit-packed hybrid run headers (host side: a handful of varints)
# ---------------------------------------------------------------------------


def _runs(buf, bit_width: int, count: Optional[int]
          ) -> Tuple[List[int], List[int], List[int], List[int]]:
    """Run headers of a hybrid stream at offset 0 of `buf`: until
    `count` values are covered (each run's count clipped to it), or to
    the end of `buf` when `count` is None."""
    is_packed: List[int] = []
    value: List[int] = []
    cum: List[int] = []
    bit_start: List[int] = []
    pos = total = 0
    vbytes = (bit_width + 7) // 8
    while (total < count) if count is not None else (pos < len(buf)):
        if pos >= len(buf):
            raise DeviceDecodeUnsupported("truncated RLE stream")
        header, pos = _varint(buf, pos)
        if header & 1:
            groups = header >> 1
            n = groups * 8
            is_packed.append(1)
            value.append(0)
            bit_start.append(pos * 8)
            pos += groups * bit_width
        else:
            n = header >> 1
            v = int.from_bytes(buf[pos:pos + vbytes], "little") \
                if vbytes else 0
            pos += vbytes
            is_packed.append(0)
            value.append(v)
            bit_start.append(0)
        total += n
        cum.append(total if count is None else min(total, count))
    return is_packed, value, cum, bit_start


def parse_rle_runs(buf, bit_width: int, count: int,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Parse the run headers of an RLE/bit-packed hybrid stream over
    `buf` (values start at offset 0) into per-run descriptor arrays for
    ops/decode.expand_rle_hybrid: (is_packed u32[R], value u32[R],
    cum-counts i32[R] inclusive, bit-start i32[R])."""
    is_packed, value, cum, bit_start = _runs(buf, bit_width, count)
    if not cum:
        raise DeviceDecodeUnsupported("empty RLE stream")
    return (np.asarray(is_packed, np.uint32), np.asarray(value, np.uint32),
            np.asarray(cum, np.int32), np.asarray(bit_start, np.int32))


# ---------------------------------------------------------------------------
# footer access (rides the process footer cache)
# ---------------------------------------------------------------------------


class _TailFile(io.RawIOBase):
    """Seekable file view for pq.read_metadata backed by the already-
    fetched tail bytes, falling back to ranged reads outside the tail."""

    def __init__(self, file_io: FileIO, path: str, size: int, tail: bytes):
        self._io = file_io
        self._path = path
        self._size = size
        self._tail = tail
        self._pos = 0

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        start = self._pos
        tail_start = self._size - len(self._tail)
        if start >= tail_start:
            off = start - tail_start
            out = self._tail[off:off + n]
        else:
            out = self._io.read_range(self._path, start, n)
        self._pos = start + len(out)
        return out


def _footer_metadata(file_io: FileIO, path: str, options=None):
    """Parsed parquet FileMetaData for `path`, via the process footer
    cache when the table allows it; a miss reads only the footer bytes
    through ranged reads, never the whole file."""
    from paimon_tpu_torch.fs.caching import footer_cache_scope, \
        global_footer_cache
    with footer_cache_scope(options):
        cache = global_footer_cache()
        md = cache.get(path)
        if md is not None:
            return md
        size = file_io.get_file_size(path)
        probe = min(size, 1 << 16)
        tail = file_io.read_range(path, size - probe, probe)
        if len(tail) < 8 or tail[-4:] != b"PAR1":
            raise DeviceDecodeUnsupported(f"not a parquet file: {path}")
        footer_len = struct.unpack("<I", tail[-8:-4])[0]
        if footer_len + 8 > probe:
            tail = file_io.read_range(path, size - footer_len - 8,
                                      footer_len + 8)
        md = pq.read_metadata(_TailFile(file_io, path, size, tail))
        cache.put(path, md)
        return md


# ---------------------------------------------------------------------------
# column-chunk decode: host plan -> one upload -> device expand -> download
# ---------------------------------------------------------------------------


def _decompress(data: memoryview, codec: Optional[pa.Codec],
                uncompressed: int) -> memoryview:
    """A page's payload, decompressed (codec None: stored as is).  The
    input goes in as an Arrow buffer: pyarrow then decompresses without
    the GIL, so concurrent readers' pages decompress in parallel."""
    if codec is None:
        return data
    return memoryview(codec.decompress(pa.py_buffer(data),
                                       decompressed_size=uncompressed))


@dataclass
class _ChunkPlan:
    """One column chunk laid out for the device: `buf` holds the int64
    table of runs and pages (at offset 0), then the level and index
    streams, the dictionary and the PLAIN values, each section 8-byte
    aligned; bit offsets in the run tables are absolute in `buf`."""
    buf: np.ndarray
    rows: int
    width: int
    max_def: int
    pages: int
    level_runs: int
    index_runs: int
    dict_off: int            # byte offset of the dictionary section
    dict_len: int            # dictionary values
    plain_off: int           # byte offset of the PLAIN section
    plain_len: int           # PLAIN value slots (pages padded to width)
    has_dict_pages: bool
    has_plain_pages: bool
    contiguous: bool         # PLAIN pages only, laid out row for row
    page_rows: np.ndarray    # int64[P]
    page_caps: np.ndarray    # int64[P]: values each page's stream holds


class _Layout:
    """Appends byte sections at 8-byte aligned offsets."""

    def __init__(self, start: int):
        self.parts: List[Tuple[int, object]] = []
        self.size = start

    def add(self, data, align: int = 8) -> int:
        off = -(-self.size // align) * align
        self.parts.append((off, data))
        self.size = off + len(data)
        return off


def _plan_chunk(data: bytes, col_meta, max_def: int) -> _ChunkPlan:
    """Host side of one chunk: walk its pages, decompress them, parse
    the run headers, and lay everything out in one buffer."""
    width = _PHYS_WIDTH[col_meta.physical_type]
    codec = None if col_meta.compression == "UNCOMPRESSED" \
        else pa.Codec(col_meta.compression.lower())
    total = col_meta.num_values
    data = memoryview(data)
    level_bw = max_def.bit_length()
    pos = seen = 0
    dict_page = None
    dict_count = 0
    # per data page: rows, kind (1 = dictionary indices), stream or
    # PLAIN payload, its runs and the values its stream holds
    pages: List[Tuple[int, int, memoryview, tuple, int, int]] = []
    levels: List[Tuple[memoryview, tuple]] = []
    while seen < total:
        if pos >= len(data):
            raise DeviceDecodeUnsupported("column chunk truncated")
        hdr, body = parse_page_header(data, pos)
        comp = hdr["compressed_size"]
        payload = data[body:body + comp]
        pos = body + comp
        ptype = hdr["type"]
        if ptype == _PAGE_DICT:
            page = _decompress(payload, codec, hdr["uncompressed_size"])
            dhdr = hdr["dict"] or {}
            if dhdr.get(2, _ENC_PLAIN) not in (_ENC_PLAIN, _ENC_PLAIN_DICT):
                raise DeviceDecodeUnsupported("non-PLAIN dictionary")
            dict_count = dhdr.get(1, 0)
            if len(page) < width * dict_count:
                raise DeviceDecodeUnsupported("PLAIN page shorter than "
                                              "values")
            dict_page = page[:width * dict_count]
            continue
        if ptype == _PAGE_DATA_V2:
            raise DeviceDecodeUnsupported("v2 data page")
        if ptype != _PAGE_DATA:
            continue                          # index pages etc.
        dh = hdr["data"]
        if dh is None:
            raise DeviceDecodeUnsupported("data page without header")
        nvals = dh.get(1, 0)
        enc = dh.get(2, _ENC_PLAIN)
        page = _decompress(payload, codec, hdr["uncompressed_size"])
        off = 0
        if max_def > 0:
            if dh.get(3, _ENC_RLE) != _ENC_RLE:
                raise DeviceDecodeUnsupported("non-RLE def levels")
            dlen = struct.unpack("<I", page[off:off + 4])[0]
            off += 4
            stream = page[off:off + dlen]
            runs = _runs(stream, level_bw, nvals)
            if not runs[2]:
                raise DeviceDecodeUnsupported("empty RLE stream")
            levels.append((stream, runs))
            off += dlen
        if enc == _ENC_PLAIN:
            body_bytes = page[off:]
            if max_def == 0 and len(body_bytes) < width * nvals:
                raise DeviceDecodeUnsupported("PLAIN page shorter than "
                                              "values")
            pages.append((nvals, 0, body_bytes, None, 0,
                          len(body_bytes) // width))
        elif enc in (_ENC_PLAIN_DICT, _ENC_RLE_DICT):
            if dict_page is None:
                raise DeviceDecodeUnsupported("dict page missing")
            bw = page[off] if off < len(page) else 0
            stream = page[off + 1:]
            runs = _runs(stream, bw, None)
            pages.append((nvals, 1, stream, runs, bw, runs[2][-1]
                          if runs[2] else 0))
        else:
            raise DeviceDecodeUnsupported(f"value encoding {enc}")
        seen += nvals
    return _layout(pages, levels, dict_page, dict_count, width, max_def)


def _layout(pages, levels, dict_page, dict_count: int, width: int,
            max_def: int) -> _ChunkPlan:
    n_pages = len(pages)
    page_rows = np.array([p[0] for p in pages], np.int64)
    rows = int(page_rows.sum())
    n_level_runs = sum(len(r[2]) for _, r in levels)
    n_index_runs = sum(len(p[3][2]) for p in pages if p[1] == 1)
    # int64 table: page row starts [P+1], page kind [P], page base [P],
    # level runs 4 x [R1], index runs 5 x [R2] (packed, value, cum,
    # bit start, width); empty run tables get one dummy run
    r1, r2 = max(n_level_runs, 1), max(n_index_runs, 1)
    table = np.zeros(3 * n_pages + 1 + 4 * r1 + 5 * r2, np.int64)
    lay = _Layout(table.nbytes)
    level_at = [lay.add(stream, 1) for stream, _ in levels]
    index_at = [lay.add(p[2], 1) if p[1] == 1 else 0 for p in pages]
    dict_off = lay.add(dict_page if dict_page is not None else b"")
    plain_off = lay.add(b"")
    plain_at = []
    for p in pages:
        plain_at.append(lay.add(p[2], width) if p[1] == 0 else 0)
    plain_len = max(1, (lay.size - plain_off + width - 1) // width)
    size = -(-(max(lay.size, plain_off + plain_len * width) + 16) // 8) * 8
    buf = np.zeros(size, np.uint8)
    for off, part in lay.parts:
        if len(part):
            buf[off:off + len(part)] = np.frombuffer(part, np.uint8)

    t = 0
    starts = np.concatenate([[0], np.cumsum(page_rows)])
    table[t:t + n_pages + 1] = starts
    t += n_pages + 1
    kinds = np.array([p[1] for p in pages], np.int64)
    table[t:t + n_pages] = kinds
    t += n_pages
    index_base = np.concatenate([[0], np.cumsum([p[5] if p[1] == 1 else 0
                                                 for p in pages])])
    table[t:t + n_pages] = [
        index_base[i] if p[1] == 1 else (plain_at[i] - plain_off) // width
        for i, p in enumerate(pages)]
    t += n_pages
    for cols, items, n_cols in (
            (r1, [(at, runs, base, None) for at, (_, runs), base
                  in zip(level_at, levels, starts)], 4),
            (r2, [(index_at[i], p[3], index_base[i], p[4])
                  for i, p in enumerate(pages) if p[1] == 1], 5)):
        block = table[t:t + n_cols * cols].reshape(n_cols, cols)
        k = 0
        for at, (packed, value, cum, bit_start), base, bw in items:
            r = len(cum)
            block[0, k:k + r] = packed
            block[1, k:k + r] = value
            block[2, k:k + r] = np.asarray(cum, np.int64) + base
            block[3, k:k + r] = np.asarray(bit_start, np.int64) + 8 * at
            if bw is not None:
                block[4, k:k + r] = bw
            k += r
        if k == 0:
            block[2, :] = 0
        else:
            block[2, k:] = block[2, k - 1]
        t += n_cols * cols
    buf[:table.nbytes] = table.view(np.uint8)
    contiguous = not kinds.any() and all(
        (plain_at[i] - plain_off) // width == starts[i]
        for i in range(n_pages))
    return _ChunkPlan(
        buf=buf, rows=rows, width=width, max_def=max_def, pages=n_pages,
        level_runs=r1, index_runs=r2, dict_off=dict_off,
        dict_len=dict_count, plain_off=plain_off, plain_len=plain_len,
        has_dict_pages=bool(kinds.any()),
        has_plain_pages=bool((kinds == 0).any()), contiguous=contiguous,
        page_rows=page_rows,
        page_caps=np.array([p[5] for p in pages], np.int64))


def _upload_chunk(plan: _ChunkPlan, dev: torch.device) -> torch.Tensor:
    """The chunk's one upload."""
    return torch.from_numpy(plan.buf).to(dev)


def _expand_chunk(plan: _ChunkPlan, buf: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """Device side of one chunk: (values as int32/int64 bit patterns
    with zeros at null slots, present mask or None, present values per
    page or None when the column has no definition levels)."""
    from paimon_tpu_torch.ops.decode import (
        dict_gather, expand_rle_at, plain_to_u32, plain_to_u64,
    )
    as_values = plain_to_u64 if plan.width == 8 else plain_to_u32
    rows, n_pages = plan.rows, plan.pages
    r1, r2 = plan.level_runs, plan.index_runs
    table = buf[:8 * (3 * n_pages + 1 + 4 * r1 + 5 * r2)].view(torch.int64)
    starts = table[:n_pages + 1]
    kinds = table[n_pages + 1:2 * n_pages + 1]
    bases = table[2 * n_pages + 1:3 * n_pages + 1]
    t = 3 * n_pages + 1
    lev = table[t:t + 4 * r1].view(4, r1)
    idx = table[t + 4 * r1:].view(5, r2)
    words = buf.view(torch.int32)
    plain = as_values(buf[plan.plain_off:], plan.plain_len)
    present = counts = None
    if plan.max_def == 0 and plan.contiguous:
        return plain[:rows], None, None
    pos = torch.arange(rows, dtype=torch.int64, device=buf.device)
    page = torch.searchsorted(starts[1:], pos, right=True)
    page_start = starts[page]
    if plan.max_def > 0:
        levels = expand_rle_at(words, lev[0], lev[1], lev[2], lev[3],
                               plan.max_def.bit_length(), pos)
        present = levels == plan.max_def
        csum = torch.cumsum(present, 0)
        before = torch.cat([csum.new_zeros(1), csum])   # present before row i
        rank = csum - 1 - before[page_start]
        counts = before[starts[1:]] - before[starts[:-1]]
    else:
        rank = pos - page_start
    values = None
    if plan.has_dict_pages:
        at = (bases[page] + rank).clamp(min=0)
        ix = expand_rle_at(words, idx[0], idx[1], idx[2], idx[3], idx[4], at)
        values = dict_gather(as_values(buf[plan.dict_off:],
                                       max(plan.dict_len, 1)), ix)
    if plan.has_plain_pages:
        v = plain[(bases[page] + rank).clamp(0, plan.plain_len - 1)]
        values = v if values is None else torch.where(kinds[page] == 1,
                                                      values, v)
    if present is not None:
        values = torch.where(present, values, values.new_zeros(()))
    return values, present, counts


def _download_chunk(plan: _ChunkPlan, values: torch.Tensor,
                    present: Optional[torch.Tensor],
                    counts: Optional[torch.Tensor]
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The chunk's download: (raw-bits values, present mask or None),
    after checking that no page claims more values than its stream
    holds."""
    n_present = plan.page_rows if counts is None \
        else counts.cpu().numpy()
    if (n_present > plan.page_caps).any():
        raise DeviceDecodeUnsupported("page shorter than its values")
    utype = np.uint64 if plan.width == 8 else np.uint32
    out = values.cpu().numpy().view(utype)
    if present is None or int(n_present.sum()) == plan.rows:
        return out, None
    return out, present.cpu().numpy()


def _decode_plan(plan: _ChunkPlan, dev: torch.device
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One planned column chunk -> (raw-bits values with zeros at null
    slots, present mask or None)."""
    if plan.rows == 0:
        utype = np.uint64 if plan.width == 8 else np.uint32
        return np.zeros(0, utype), None
    values, present, counts = _expand_chunk(plan, _upload_chunk(plan, dev))
    return _download_chunk(plan, values, present, counts)


def _arrow_array(values: np.ndarray, mask: Optional[np.ndarray],
                 field_type: pa.DataType) -> pa.Array:
    """Raw-bits values + presence mask -> Arrow array of the footer
    schema's type, zero-copy via from_buffers."""
    n = len(values)
    phys_bits = values.dtype.itemsize * 8
    if field_type.bit_width != phys_bits:
        if pa.types.is_integer(field_type) \
                and field_type.bit_width < phys_bits:
            # INT(8/16) logical types store sign-extended in INT32:
            # truncating cast recovers the narrow value exactly
            signed = values.view(np.int32 if phys_bits == 32 else np.int64)
            values = signed.astype(field_type.to_pandas_dtype())
        else:
            raise DeviceDecodeUnsupported(
                f"arrow {field_type} vs physical width {phys_bits}")
    validity = None
    null_count = 0
    if mask is not None:
        null_count = int(n - mask.sum())
        validity = pa.py_buffer(
            np.packbits(mask, bitorder="little").tobytes())
    return pa.Array.from_buffers(
        field_type, n,
        [validity, pa.py_buffer(np.ascontiguousarray(values))],
        null_count=null_count)


def device_decode_supported(md, columns: Sequence[str]) -> bool:
    """Cheap pre-check (footer only) that every requested column is
    inside the decode plane's coverage."""
    try:
        _check_supported(md, columns)
        return True
    except DeviceDecodeUnsupported:
        return False


def _check_supported(md, columns: Sequence[str]) -> Dict[str, int]:
    schema = md.schema
    by_name = {schema.column(i).name: i for i in range(len(schema.names))}
    out = {}
    for name in columns:
        ci = by_name.get(name)
        if ci is None:
            raise DeviceDecodeUnsupported(f"no flat column {name!r}")
        col_schema = schema.column(ci)
        if col_schema.max_repetition_level != 0:
            raise DeviceDecodeUnsupported(f"nested column {name!r}")
        if col_schema.physical_type not in _PHYS_WIDTH:
            raise DeviceDecodeUnsupported(
                f"physical type {col_schema.physical_type}")
        for rg in range(md.num_row_groups):
            cm = md.row_group(rg).column(ci)
            if cm.compression not in _CODECS:
                raise DeviceDecodeUnsupported(f"codec {cm.compression}")
            unknown = set(cm.encodings) - _ENCODINGS
            if unknown:
                raise DeviceDecodeUnsupported(
                    f"encodings {sorted(unknown)} in {name!r}")
        out[name] = ci
    return out


# errors that route a file back to the pyarrow host path: the typed
# coverage signal, plus what the hand-rolled thrift and page parsers
# raise on byte shapes they never anticipated (truncated varints, absent
# header fields).  Never RuntimeError: a device-side failure surfaces.
_FALLBACK_ERRORS = (DeviceDecodeUnsupported, IndexError, KeyError,
                    TypeError, ValueError, struct.error)


def maybe_read_device(file_io: FileIO, path: str,
                      projection: Optional[List[str]] = None,
                      options=None, device=None) -> Optional[pa.Table]:
    """read_parquet_device, or None when the file needs the pyarrow
    host path (the fallback is counted)."""
    try:
        return read_parquet_device(file_io, path, projection, options,
                                   device=device)
    except _FALLBACK_ERRORS:
        _count("fallbacks")
        return None


def read_parquet_device(file_io: FileIO, path: str,
                        projection: Optional[List[str]] = None,
                        options=None,
                        row_groups: Optional[Sequence[int]] = None,
                        device=None) -> pa.Table:
    """Read a parquet file through the device decode plane on `device`
    (None = cuda); identical to the pyarrow reader for covered files,
    raises DeviceDecodeUnsupported otherwise.  `row_groups` restricts
    the read (the streamed iterator reads one group at a time)."""
    dev = resolve_device(device)
    md = _footer_metadata(file_io, path, options)
    arrow_schema = md.schema.to_arrow_schema()
    names = list(projection) if projection else list(arrow_schema.names)
    col_idx = _check_supported(md, names)
    groups = list(row_groups) if row_groups is not None \
        else list(range(md.num_row_groups))

    # one ranged read per (row group, column) chunk, in one call
    ranges: List[Tuple[int, int]] = []
    keys: List[Tuple[int, str]] = []
    for rg in groups:
        for name in names:
            cm = md.row_group(rg).column(col_idx[name])
            start = cm.data_page_offset
            if cm.dictionary_page_offset is not None:
                start = min(start, cm.dictionary_page_offset)
            ranges.append((start, cm.total_compressed_size))
            keys.append((rg, name))
    blobs = file_io.read_ranges(path, ranges) if ranges else []
    chunks = dict(zip(keys, blobs))

    def plan(key):
        ci = col_idx[key[1]]
        return _plan_chunk(chunks[key], md.row_group(key[0]).column(ci),
                           md.schema.column(ci).max_definition_level)

    # a whole file's chunks are planned by a pool (decompression runs
    # without the GIL), in chunk order, ahead of the device work; the
    # streamed iterator's row groups are planned in the caller's
    # thread, since its callers already read every sorted run in a
    # thread of its own
    arrays: Dict[str, List[pa.Array]] = {n: [] for n in names}
    pool = ThreadPoolExecutor(min(_PLAN_THREADS, len(keys))) \
        if row_groups is None and len(keys) > 1 else None
    try:
        planned = pool.map(plan, keys) if pool else map(plan, keys)
        for (rg, name), chunk in zip(keys, planned):
            values, mask = _decode_plan(chunk, dev)
            arrays[name].append(_arrow_array(
                values, mask, arrow_schema.field(name).type))
    finally:
        if pool:
            pool.shutdown()
    out = pa.table(
        [pa.chunked_array(arrays[n], type=arrow_schema.field(n).type)
         for n in names],
        schema=pa.schema([arrow_schema.field(n) for n in names]))
    if row_groups is None:                  # partial reads count once,
        _count("files")                     # in the iterator
    return out


def maybe_iter_batches_device(file_io: FileIO, path: str, batch_rows: int,
                              options=None, device=None):
    """iter_batches_device, or None when the footer shows the file
    outside coverage (the fallback is counted)."""
    try:
        return iter_batches_device(file_io, path, batch_rows, options,
                                   device=device)
    except _FALLBACK_ERRORS:
        _count("fallbacks")
        return None


def iter_batches_device(file_io: FileIO, path: str, batch_rows: int,
                        options=None, device=None):
    """Streamed device decode: yields the file as bounded Arrow tables,
    fetching and decoding one row group at a time.  Raises
    DeviceDecodeUnsupported before yielding anything when the footer
    shows the file outside coverage."""
    md = _footer_metadata(file_io, path, options)
    _check_supported(md, list(md.schema.to_arrow_schema().names))
    return _iter_batches_device(file_io, path, batch_rows, options, md,
                                resolve_device(device))


def _iter_batches_device(file_io, path, batch_rows, options, md, dev):
    _count("files")
    for rg in range(md.num_row_groups):
        try:
            t = read_parquet_device(file_io, path, options=options,
                                    row_groups=[rg], device=dev)
        except _FALLBACK_ERRORS:
            # a page shape the footer cannot reveal (v2 data pages, odd
            # in-page encodings): the remaining row groups decode
            # through pyarrow; earlier groups already yielded the same
            # rows, so the stream stays seamless
            _count("fallbacks")
            data = file_io.read_bytes(path)
            pf = pq.ParquetFile(io.BytesIO(data), metadata=md)
            for rb in pf.iter_batches(
                    batch_size=batch_rows,
                    row_groups=list(range(rg, md.num_row_groups))):
                yield pa.Table.from_batches([rb])
            return
        for start in range(0, t.num_rows, batch_rows):
            yield t.slice(start, batch_rows)
