"""The port's device decode plane against the reference's and pyarrow.

paimon_tpu_torch.format.rawpage and ops/decode (device="cpu": the torch
ops on the CPU) against paimon_tpu.format.rawpage and its jnp ops on
the same files and arrays, made with numpy from seeds: the primitives
element for element, whole files against both pyarrow's read and the
reference's device read across codecs, dictionaries, null densities,
row-group and page shapes, narrow ints, dates and projections; the
fallbacks of the option's contract (strings, v2 data pages, other
codecs) counted in DECODE_COUNTS, and zero fallbacks for every covered
file, so that a bug cannot pass as a fallback; tables with
read.device-decode=true scanned and compacted against the reference per
merge engine.  Every comparison is exact.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from paimon_tpu.format import rawpage as ref_raw
from paimon_tpu.fs.fileio import LocalFileIO as RefFileIO
from paimon_tpu.ops import decode as ref_dec
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import IntType as RefInt
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch.format import rawpage
from paimon_tpu_torch.fs.fileio import LocalFileIO
from paimon_tpu_torch.ops import decode
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, IntType, VarCharType

FIO = LocalFileIO()


@pytest.fixture(autouse=True)
def counts(monkeypatch):
    fresh = {"files": 0, "fallbacks": 0}
    monkeypatch.setattr(rawpage, "DECODE_COUNTS", fresh)
    return fresh


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def u32(x):
    return x.numpy().view(np.uint32)


# -- primitives ---------------------------------------------------------------

@pytest.mark.parametrize("width", [0, 1, 3, 7, 13, 20, 31, 32])
def test_unpack_bits_matches_reference(width):
    import jax.numpy as jnp
    rng = np.random.default_rng(width)
    words = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    offs = rng.integers(0, (len(words) - 2) * 32 - width, 500).astype(
        np.int32)
    want = np.asarray(ref_dec.unpack_bits(jnp.asarray(words), width,
                                          jnp.asarray(offs)))
    got = decode.unpack_bits(t(words.view(np.int32)), width, t(offs))
    np.testing.assert_array_equal(u32(got), want)


def _hybrid(rng, count, width):
    """An RLE/bit-packed hybrid stream of `count` values: (bytes,
    values)."""
    out, vals = bytearray(), []
    while len(vals) < count:
        if rng.random() < 0.5:
            n = int(rng.integers(1, 40))
            v = int(rng.integers(0, 1 << width)) if width else 0
            out += _uvarint(n << 1)
            out += v.to_bytes((width + 7) // 8, "little")
            vals += [v] * n
        else:
            groups = int(rng.integers(1, 5))
            vs = rng.integers(0, 1 << width, groups * 8) if width \
                else np.zeros(groups * 8, np.int64)
            out += _uvarint((groups << 1) | 1)
            bits = np.unpackbits(vs.astype(">u8").view(np.uint8).reshape(
                -1, 8)[:, ::-1], axis=1, bitorder="little")[:, :width]
            out += np.packbits(bits.reshape(-1), bitorder="little").tobytes()
            vals += vs.tolist()
    return bytes(out), np.array(vals[:count], np.uint32)


def _uvarint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return out


@pytest.mark.parametrize("width", [0, 1, 2, 5, 9, 17, 32])
def test_expand_rle_hybrid_matches_reference(width):
    import jax.numpy as jnp
    rng = np.random.default_rng(40 + width)
    count = 3000
    buf, vals = _hybrid(rng, count, width)
    runs = ref_raw.parse_rle_runs(buf, width, count)
    for a, b in zip(runs, rawpage.parse_rle_runs(buf, width, count)):
        np.testing.assert_array_equal(a, b)
    words = np.frombuffer(buf + b"\0" * (8 - len(buf) % 4), np.uint32)
    want = np.asarray(ref_dec.expand_rle_hybrid(
        jnp.asarray(words), *(jnp.asarray(r) for r in runs), width, count))
    got = decode.expand_rle_hybrid(
        t(words.view(np.int32)), *(t(r.astype(np.int64)) for r in runs),
        width, count)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(want, vals)


def test_plain_and_key_lanes_match_reference():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    n = 4096
    i64 = rng.integers(-1 << 62, 1 << 62, n)
    f64 = rng.standard_normal(n)
    f64[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-310, -1e-310]
    i32 = rng.integers(-1 << 31, 1 << 31, n).astype(np.int32)
    for raw, width in ((i64, 8), (f64, 8), (i32, 4)):
        b = np.frombuffer(raw.tobytes(), np.uint8)
        fn, ref_fn = ((decode.plain_to_u64, ref_dec.plain_to_u64)
                      if width == 8 else
                      (decode.plain_to_u32, ref_dec.plain_to_u32))
        got = fn(t(b.copy()), n).numpy()
        want = np.asarray(ref_fn(jnp.asarray(b), n))
        np.testing.assert_array_equal(got.view(want.dtype), want)
    for port_fn, ref_fn, raw in (
            (decode.int64_to_key_lanes, ref_dec.int64_to_key_lanes, i64),
            (decode.float64_to_key_lanes, ref_dec.float64_to_key_lanes,
             f64.view(np.int64)),
            (decode.int32_to_key_lanes, ref_dec.int32_to_key_lanes, i32)):
        ref_in = raw.view(np.uint64) if raw.itemsize == 8 \
            else raw.view(np.uint32)
        want = [np.asarray(x) for x in ref_fn(jnp.asarray(ref_in))]
        got = [x.numpy() for x in port_fn(t(raw))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(w.dtype), w)


def test_dict_gather_and_expand_nulls_match_reference():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    dict_vals = rng.integers(0, 1 << 60, 37)
    idx = rng.integers(0, 45, 2000).astype(np.uint32)   # some out of range
    want = np.asarray(ref_dec.dict_gather(jnp.asarray(dict_vals),
                                          jnp.asarray(idx)))
    got = decode.dict_gather(t(dict_vals), t(idx.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    present = rng.random(2048) < 0.7
    vals = rng.integers(0, 1 << 40, 2048)
    w_full, w_present = ref_dec.expand_nulls(jnp.asarray(vals),
                                             jnp.asarray(present))
    g_full, g_present = decode.expand_nulls(t(vals), t(present))
    np.testing.assert_array_equal(g_full.numpy(), np.asarray(w_full))
    np.testing.assert_array_equal(g_present.numpy(), np.asarray(w_present))
    for n, floor in ((0, 1024), (1025, 1024), (3, 8), (1 << 20, 1024)):
        assert decode.pad_pow2(n, floor) == ref_dec.pad_pow2(n, floor)


@pytest.mark.parametrize("keep", ["last", "first"])
@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_fused_decode_merge_matches_reference(keep, kind):
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    n = 2048
    keys = rng.integers(-1 << 40, 1 << 40, n // 2).repeat(2)
    if kind == "float64":
        keys = (keys / 7.0).view(np.int64)
    rng.shuffle(keys)
    seq = rng.permutation(n).astype(np.int64)
    invalid = np.zeros(n, np.uint32)
    invalid[-100:] = 1
    want = ref_dec.fused_decode_merge(
        jnp.asarray(keys.view(np.uint8)), jnp.asarray(seq.view(np.uint8)),
        jnp.asarray(invalid), keep=keep, kind=kind)
    got = decode.fused_decode_merge(
        t(keys.view(np.uint8)), t(seq.view(np.uint8)),
        t(invalid.view(np.int32)), keep=keep, kind=kind)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)


# -- whole files against pyarrow and the reference ----------------------------

def roundtrip(tmp_path, table, name, counts, projection=None, **write_kw):
    """The port's device read of a parquet file equals pyarrow's and
    the reference's, without a fallback."""
    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(table, path, **write_kw)
    oracle = pq.ParquetFile(path).read(columns=projection)
    got = rawpage.maybe_read_device(FIO, path, projection, device="cpu")
    assert counts == {"files": 1, "fallbacks": 0}
    assert got.equals(oracle), f"{name}: device decode != pyarrow"
    assert got.equals(ref_raw.read_parquet_device(RefFileIO(), path,
                                                  projection))
    counts.update(files=0)
    return path


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("codec", ["none", "zstd", "snappy", "gzip"])
def test_plain_fixed_width(tmp_path, counts, seed, codec):
    rng = np.random.default_rng(seed)
    n = 8_000
    table = pa.table({
        "i64": pa.array(rng.integers(-1 << 60, 1 << 60, n), pa.int64()),
        "f64": pa.array(rng.standard_normal(n), pa.float64()),
        "i32": pa.array(rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)),
        "f32": pa.array(rng.random(n).astype(np.float32))})
    roundtrip(tmp_path, table, f"plain_{codec}", counts, compression=codec,
              use_dictionary=False)


@pytest.mark.parametrize("seed, cards", [(0, 1), (0, 7), (1, 100),
                                         (2, 1000), (3, 1 << 40)])
def test_dictionary(tmp_path, counts, seed, cards):
    """RLE_DICTIONARY index streams and PLAIN dictionary pages; at the
    highest cardinality the dictionary outgrows its page limit and the
    writer falls back to PLAIN pages inside the same chunk."""
    rng = np.random.default_rng(seed)
    n = 16_000
    table = pa.table({
        "a": pa.array(rng.integers(0, cards, n), pa.int64()),
        "b": pa.array(rng.integers(0, cards, n) * 0.5, pa.float64()),
        "c": pa.array(rng.integers(0, cards, n).astype(np.int32))})
    roundtrip(tmp_path, table, f"dict_{cards}", counts, compression="zstd",
              dictionary_pagesize_limit=64 << 10, data_page_size=16 << 10)


@pytest.mark.parametrize("dictionary", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.125, 0.5, 0.97, 1.0])
def test_null_density(tmp_path, counts, density, dictionary):
    rng = np.random.default_rng(17)
    n = 6_000
    table = pa.table({
        "x": pa.array(rng.integers(0, 1 << 40, n), pa.int64(),
                      mask=rng.random(n) < density),
        "y": pa.array(rng.integers(0, 30, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < density),
        "z": pa.array(rng.random(n), pa.float64(),
                      mask=rng.random(n) < density)})
    roundtrip(tmp_path, table, f"nulls_{density}", counts,
              compression="zstd", use_dictionary=dictionary,
              data_page_size=8 << 10)


@pytest.mark.parametrize("rg, page", [(977, 512), (5_000, 2048),
                                      (50_000, 1 << 20)])
def test_row_group_and_page_shapes(tmp_path, counts, rg, page):
    rng = np.random.default_rng(23)
    n = 8_000
    table = pa.table({
        "k": pa.array(rng.integers(0, 1 << 50, n), pa.int64()),
        "d": pa.array(rng.integers(0, 30, n), pa.int64()),
        "nul": pa.array(rng.integers(0, 99, n), pa.int64(),
                        mask=rng.random(n) < 0.2)})
    roundtrip(tmp_path, table, f"shapes_{rg}_{page}", counts,
              compression="zstd", row_group_size=rg, data_page_size=page)


@pytest.mark.parametrize("dictionary", [False, True])
def test_temporal_and_narrow_ints(tmp_path, counts, dictionary):
    rng = np.random.default_rng(5)
    n = 8_000
    table = pa.table({
        "ts": pa.array(rng.integers(0, 1 << 44, n), pa.timestamp("us")),
        "d32": pa.array(rng.integers(0, 20_000, n).astype(np.int32),
                        pa.date32(), mask=rng.random(n) < 0.1),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-1 << 15, 1 << 15, n).astype(np.int16))})
    roundtrip(tmp_path, table, "temporal", counts, compression="zstd",
              use_dictionary=dictionary)


def test_projection_and_column_order(tmp_path, counts):
    rng = np.random.default_rng(7)
    n = 5_000
    table = pa.table({
        "a": pa.array(rng.integers(0, 10, n), pa.int64()),
        "b": pa.array(rng.random(n), pa.float64()),
        "c": pa.array(rng.integers(0, 9, n).astype(np.int32))})
    roundtrip(tmp_path, table, "proj", counts, projection=["c", "a"],
              compression="zstd")


def test_unsupported_shapes_raise(tmp_path, counts):
    """Strings, v2 data pages and other codecs raise the typed fallback
    signal in both packages."""
    n = 1_000
    rng = np.random.default_rng(1)
    ints = pa.table({"x": pa.array(rng.integers(0, 1 << 40, n), pa.int64())})
    cases = [("str", pa.table({"s": pa.array([f"v{i}" for i in range(n)])}),
              {}),
             ("v2", ints, {"data_page_version": "2.0",
                           "use_dictionary": False}),
             ("lz4", ints, {"compression": "lz4"})]
    for name, table, kw in cases:
        path = str(tmp_path / f"{name}.parquet")
        pq.write_table(table, path, **kw)
        with pytest.raises(rawpage.DeviceDecodeUnsupported):
            rawpage.read_parquet_device(FIO, path, device="cpu")
        with pytest.raises(ref_raw.DeviceDecodeUnsupported):
            ref_raw.read_parquet_device(RefFileIO(), path)
        assert rawpage.device_decode_supported(
            pq.read_metadata(path), table.column_names) is (name == "v2")
        assert rawpage.maybe_read_device(FIO, path, device="cpu") is None
    assert counts == {"files": 0, "fallbacks": 3}


def test_caught_errors_exclude_runtime_errors():
    """A device-side failure (a RuntimeError on the card, its OOM a
    subclass) is never mistaken for a coverage fallback."""
    assert not any(issubclass(RuntimeError, e) or issubclass(e, RuntimeError)
                   for e in rawpage._FALLBACK_ERRORS)
    assert not issubclass(torch.cuda.OutOfMemoryError,
                          rawpage._FALLBACK_ERRORS)


def test_iter_batches_streams_and_falls_back_midfile(tmp_path, counts):
    """One row group at a time; a file whose pages the footer cannot
    reveal as v2 reads its remaining row groups through pyarrow, counted
    once, with the same rows."""
    rng = np.random.default_rng(31)
    n = 24_000
    table = pa.table({"a": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
                      "b": pa.array(rng.random(n), pa.float64())})
    p1 = str(tmp_path / "v1.parquet")
    pq.write_table(table, p1, compression="zstd", use_dictionary=False,
                   row_group_size=5_000)
    parts = list(rawpage.iter_batches_device(FIO, p1, 2_000, device="cpu"))
    assert max(p.num_rows for p in parts) <= 2_000
    assert pa.concat_tables(parts).equals(pq.ParquetFile(p1).read())
    assert counts == {"files": 1, "fallbacks": 0}
    p2 = str(tmp_path / "v2.parquet")
    pq.write_table(table, p2, compression="zstd", use_dictionary=False,
                   row_group_size=5_000, data_page_version="2.0")
    got = pa.concat_tables(list(rawpage.iter_batches_device(
        FIO, p2, 2_000, device="cpu")))
    assert got.equals(pq.ParquetFile(p2).read())
    assert counts == {"files": 2, "fallbacks": 1}


def test_footer_cache_honours_the_option(tmp_path):
    from paimon_tpu_torch.fs.caching import footer_cache_scope, \
        global_footer_cache
    from paimon_tpu_torch.options import CoreOptions, Options
    path = str(tmp_path / "data-1.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2], pa.int64())}), path)
    cache = global_footer_cache()
    cache.evict(path)
    off = CoreOptions(Options({"read.cache.footer": "false"}))
    rawpage.read_parquet_device(FIO, path, options=off, device="cpu")
    assert cache.get(path) is None
    rawpage.read_parquet_device(FIO, path, options=CoreOptions(Options({})),
                                device="cpu")
    assert cache.get(path) is not None
    with footer_cache_scope(off):
        assert cache.get(path) is None
    cache.evict(path)


def test_ranged_reads(tmp_path):
    path = str(tmp_path / "f.bin")
    data = bytes(range(256)) * 4
    FIO.write_bytes(path, data)
    assert FIO.get_file_size(path) == len(data)
    assert FIO.read_range(path, 10, 5) == data[10:15]
    assert FIO.read_ranges(path, [(0, 3), (1000, 100), (7, 0)]) == \
        [data[:3], data[1000:], b""]


# -- tables with read.device-decode=true ---------------------------------------

def engine_options(engine):
    opts = {"bucket": "2", "write-only": "true", "merge-engine": engine,
            "parquet.enable.dictionary": "false",
            "tpu.merge.stream-threshold-rows": "2048",
            "tpu.merge.chunk-rows": "512"}
    if engine == "aggregation":
        opts.update({"fields.v1.aggregate-function": "sum",
                     "fields.v2.aggregate-function": "max"})
    return opts


def engine_tables(tmp_path, engine, commits=3, rows=4_000, seed=3):
    """The same commits written by both packages."""
    opts = engine_options(engine)
    out = []
    for cls, schema_cls, big, dbl, i32, kw in (
            (FileStoreTable, Schema, BigIntType, DoubleType, IntType,
             {"device": "cpu"}),
            (RefTable, RefSchema, RefBigInt, RefDouble, RefInt, {})):
        schema = (schema_cls.builder().column("id", big(False))
                  .column("v1", big()).column("v2", dbl())
                  .column("v3", i32()).primary_key("id").options(opts)
                  .build())
        table = cls.create(str(tmp_path / cls.__module__.split(".")[0]),
                           schema, **kw)
        rng = np.random.default_rng(seed)
        for _ in range(commits):
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(pa.table({
                    "id": pa.array(rng.integers(0, rows, rows), pa.int64()),
                    "v1": pa.array(rng.integers(0, 1 << 30, rows),
                                   pa.int64(), mask=rng.random(rows) < 0.1),
                    "v2": pa.array(rng.random(rows), pa.float64()),
                    "v3": pa.array(rng.integers(0, 50, rows).astype(
                        np.int32))}))
                wb.new_commit().commit(w.prepare_commit())
        out.append(table)
    return out


ENGINES = ["deduplicate", "first-row", "aggregation", "partial-update"]


@pytest.mark.parametrize("engine", ENGINES)
def test_table_scan_and_compaction_per_engine(tmp_path, counts, engine):
    """A table with read.device-decode=true opens, scans and compacts
    (the streamed rewrite) in the port with the reference's rows, every
    file through the device decode plane."""
    port_t, ref_t = engine_tables(tmp_path, engine)
    dev = {"read.device-decode": "true"}
    port_d, ref_d = port_t.copy(dev), ref_t.copy(dev)
    want = ref_d.to_arrow().sort_by("id")
    assert port_d.to_arrow().sort_by("id").equals(want)
    assert counts["files"] > 0 and counts["fallbacks"] == 0
    scanned = counts["files"]
    port_d.compact(full=True)
    ref_d.compact(full=True)
    assert counts["files"] > scanned and counts["fallbacks"] == 0
    assert port_d.to_arrow().sort_by("id").equals(want)
    assert ref_d.to_arrow().sort_by("id").equals(want)


def test_created_device_decode_table_writes_and_reads(tmp_path, counts):
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", DoubleType()).primary_key("id")
              .options({"bucket": "1", "read.device-decode": "true"})
              .build())
    table = FileStoreTable.create(str(tmp_path / "t"), schema, device="cpu")
    for k in range(3):
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(pa.table({"id": pa.array(np.arange(100) + 50 * k),
                                    "v": pa.array(np.full(100, float(k)))}))
            wb.new_commit().commit(w.prepare_commit())
    got = table.to_arrow().sort_by("id")
    assert got.num_rows == 200
    assert got.column("v").to_pylist() == [0.0] * 50 + [1.0] * 50 \
        + [2.0] * 100
    table.compact(full=True)
    assert table.to_arrow().sort_by("id").equals(got)
    assert counts["files"] >= 4 and counts["fallbacks"] == 0


def test_string_schema_falls_back_identically(tmp_path, counts):
    """String columns take the pyarrow path under read.device-decode,
    in the scan and in the streamed compaction, counted per file, with
    the reference's rows."""
    options = {"bucket": "1", "read.device-decode": "true",
               "tpu.merge.stream-threshold-rows": "100",
               "tpu.merge.chunk-rows": "64"}
    reads = []
    for cls, schema_cls, big, vc, kw in (
            (FileStoreTable, Schema, BigIntType, VarCharType,
             {"device": "cpu"}),
            (RefTable, RefSchema, RefBigInt, RefVarChar, {})):
        schema = (schema_cls.builder().column("id", big(False))
                  .column("s", vc()).primary_key("id").options(options)
                  .build())
        table = cls.create(str(tmp_path / cls.__module__.split(".")[0]),
                           schema, **kw)
        for k in range(2):
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(pa.table({
                    "id": pa.array(np.arange(500) + 250 * k, pa.int64()),
                    "s": pa.array([f"row-{i}-{k}" for i in range(500)])}))
                wb.new_commit().commit(w.prepare_commit())
        scanned = table.to_arrow().sort_by("id")
        table.compact(full=True)
        reads.append((scanned, table.to_arrow().sort_by("id")))
    assert reads[0][0].equals(reads[1][0])
    assert reads[0][1].equals(reads[1][1])
    # two files scanned, two streamed into the compaction, one read back
    assert counts == {"files": 0, "fallbacks": 5}
