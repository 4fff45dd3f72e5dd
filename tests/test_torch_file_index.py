"""Per-file column indexes of paimon_tpu_torch against paimon_tpu.

The bloom, bitmap, bit-sliced and range-bitmap indexes and their v1 and
v2 container blobs are built by both packages from the same seeded
columns and compared byte for byte; each package deserializes the
other's blobs; `eval` masks and `evaluate_skip` agree over a grid of
operators and literals; and the reference's own cases of
tests/test_file_index.py and tests/test_bitmap_index.py that apply to
primary-key tables run on the port.  Every comparison is exact.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.index.bitmap as RB
import paimon_tpu.index.bloom as RBloom
import paimon_tpu.index.file_index as RFI
import paimon_tpu.index.roaring as RR
import paimon_tpu.predicate as RefP
import paimon_tpu_torch.index.bitmap as B
import paimon_tpu_torch.index.bloom as Bloom
import paimon_tpu_torch.index.file_index as FI
import paimon_tpu_torch.index.roaring as R
import paimon_tpu_torch.predicate as P


def _positions(mask):
    return sorted(np.flatnonzero(mask).tolist())


def _expected(vals, fn):
    return sorted(i for i, v in enumerate(vals)
                  if v is not None and fn(v))


def _with_nulls(rng, arr, frac=0.1):
    mask = rng.random(len(arr)) < frac
    return pa.array(arr, mask=mask) if len(arr) else pa.array(arr)


def _column(kind, n, seed=0):
    """Seeded columns of every type the indexes take, 1 in 10 null."""
    rng = np.random.default_rng(seed)
    if kind in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(kind)
        vals = rng.integers(max(info.min, -1000), min(info.max, 1000), n)
        return _with_nulls(rng, vals.astype(kind))
    if kind == "float32":
        return _with_nulls(rng, rng.normal(size=n).astype(np.float32))
    if kind == "double_nan":
        v = rng.normal(size=n)
        v[rng.random(n) < 0.05] = np.nan
        return _with_nulls(rng, v)
    if kind == "string":
        words = [f"w{i}" for i in range(50)] + ["", "é", "a\U0001F600"]
        return pa.array([None if rng.random() < 0.1 else
                         words[rng.integers(len(words))]
                         for _ in range(n)], pa.string())
    if kind == "binary":
        return pa.array([None if rng.random() < 0.1 else
                         bytes([rng.integers(4), rng.integers(256)])
                         for _ in range(n)], pa.binary())
    if kind == "date":
        base = datetime.date(2024, 1, 1)
        return pa.array([None if rng.random() < 0.1 else
                         base + datetime.timedelta(int(rng.integers(60)))
                         for _ in range(n)], pa.date32())
    if kind == "timestamp":
        v = rng.integers(0, 10 ** 12, n)
        return pa.array(v, pa.timestamp("us"),
                        mask=rng.random(n) < 0.1)
    if kind == "all_null":
        return pa.array([None] * n, pa.int64())
    if kind == "single":
        return pa.array([42], pa.int64())
    if kind == "wide":                   # more than 2^16 distinct values
        return pa.array(rng.permutation(70_000).astype(np.int64))
    raise ValueError(kind)


KINDS = ["int8", "int16", "int32", "int64", "float32", "double_nan",
         "string", "binary", "date", "timestamp", "all_null", "single",
         "wide"]


def _table(kind, n=3000, seed=0):
    col = _column(kind, 1 if kind == "single" else n, seed)
    return pa.table({"c": col})


def _spec(kind):
    spec = {"bloom-filter": ["c"]}
    if kind != "date":
        spec["bitmap"] = ["c"]
    if kind in ("int8", "int16", "int32", "int64", "timestamp",
                "all_null", "single", "wide"):
        spec["bsi"] = ["c"]
    if kind in ("int8", "int16", "int32", "int64", "float32",
                "timestamp", "all_null", "single", "wide"):
        spec["range-bitmap"] = ["c"]
    return spec


def _same(port_fn, ref_fn):
    """Both calls' results, or the same exception type from both (a date
    column's bitmap index raises ArrowNotImplementedError in the
    reference, and in the port alike)."""
    try:
        want = ref_fn()
    except Exception as e:              # noqa: BLE001 — compared below
        with pytest.raises(type(e)):
            port_fn()
        return None, None, True
    return port_fn(), want, False


# -- byte equality ------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_v2_blob_equals_reference(kind):
    t = _table(kind)
    for fpp in (0.01, 0.2):
        got, want, _ = _same(
            lambda: FI.build_indexes_blob(t, _spec(kind), fpp),
            lambda: RFI.build_indexes_blob(t, _spec(kind), fpp))
        assert got == want


def test_date_bitmap_raises_as_reference():
    t = _table("date")
    _, _, raised = _same(
        lambda: FI.build_indexes_blob(t, {"bitmap": ["c"]}),
        lambda: RFI.build_indexes_blob(t, {"bitmap": ["c"]}))
    assert raised


@pytest.mark.parametrize("index", ["bitmap", "bsi", "range"])
@pytest.mark.parametrize("kind", KINDS)
def test_each_index_serializes_as_reference(kind, index):
    col = pa.chunked_array([_table(kind).column("c").combine_chunks()])
    port, ref = {"bitmap": (B.BitmapIndex, RB.BitmapIndex),
                 "bsi": (B.BSIIndex, RB.BSIIndex),
                 "range": (B.RangeBitmapIndex, RB.RangeBitmapIndex)}[index]
    got, want, _ = _same(lambda: port.build(col), lambda: ref.build(col))
    assert (got is None) == (want is None)
    if want is not None:
        assert got.serialize() == want.serialize()


@pytest.mark.parametrize("n, nulls, bins", [
    (70_000, 0.0, 64), (200_000, 0.5, 64), (150_000, 0.97, 64),
    (65_536, 0.0, 3), (131_079, 0.1, 300)])
def test_range_bitmap_across_containers_equals_reference(n, nulls, bins):
    """The port encodes a range bitmap's cumulative lists container by
    container from the row bins; over many containers, dense and sparse
    (and the list-by-list path above 254 bins) the bytes are the
    reference's."""
    rng = np.random.default_rng(n)
    col = pa.chunked_array([pa.array(rng.integers(-(1 << 40), 1 << 40, n),
                                     mask=rng.random(n) < nulls)])
    got = B.RangeBitmapIndex.build(col, max_bins=bins)
    want = RB.RangeBitmapIndex.build(col, max_bins=bins)
    assert got.serialize() == want.serialize()
    assert [np.array_equal(a, b) for a, b in
            zip(got.cum_pos, want.cum_pos)] == [True] * len(want.cum_pos)
    h = Bloom.hash_column(col)
    assert Bloom.BloomFilter.build(h, 0.01).serialize() == \
        RBloom.BloomFilter.build(h, 0.01).serialize()


def test_bitmap_declines_above_max_distinct():
    col = pa.chunked_array([_column("wide", 0)])
    assert B.BitmapIndex.build(col) is None
    assert RB.BitmapIndex.build(col) is None
    assert FI.build_indexes_blob(pa.table({"c": col}), {"bitmap": ["c"]}) \
        is None


@pytest.mark.parametrize("kind", ["int64", "string", "binary",
                                  "double_nan", "date"])
def test_v1_blob_and_bloom_equal_reference(kind):
    t = _table(kind)
    assert Bloom.build_file_index(t, ["c", "missing"]) == \
        RBloom.build_file_index(t, ["c", "missing"])
    h = Bloom.hash_column(t.column("c"))
    assert np.array_equal(h, RBloom.hash_column(t.column("c")))
    bf = Bloom.BloomFilter.build(h, 0.01)
    assert bf.serialize() == RBloom.BloomFilter.build(h, 0.01).serialize()
    v = t.column("c").drop_null()[0].as_py()
    assert Bloom.hash_value(v, t.column("c").type) == \
        RBloom.hash_value(v, t.column("c").type)


def _strings(rng, n, maxlen):
    alpha = list("abcdefghé€\U0001F600xyz0123")
    return [None if rng.random() < 0.1 else
            "".join(rng.choice(alpha, rng.integers(0, maxlen)))
            for _ in range(n)]


@pytest.mark.parametrize("case", ["short", "long", "empty", "all_null",
                                  "word_edges", "sliced", "binary",
                                  "large_string", "chunked"])
def test_string_hashes_equal_reference(case):
    """The port hashes a string or binary column in one vectorised pass;
    every row's hash equals the reference's per-row loop."""
    rng = np.random.default_rng(17)
    arr = {"short": lambda: pa.array(_strings(rng, 2000, 12)),
           "long": lambda: pa.array(_strings(rng, 300, 400)),
           "empty": lambda: pa.array([], pa.string()),
           "all_null": lambda: pa.array([None, None], pa.string()),
           "word_edges": lambda: pa.array(["", "a", "ab", "abc", "abcd",
                                           "abcde", "abcdefgh"]),
           "sliced": lambda: pa.array(_strings(rng, 2000, 10)).slice(7, 999),
           "binary": lambda: pa.array([b"\x00\xff" * k for k in range(30)]
                                      + [None], pa.binary()),
           "large_string": lambda: pa.array(_strings(rng, 100, 12),
                                            pa.large_string()),
           "chunked": lambda: pa.chunked_array([
               pa.array(_strings(rng, 100, 9)),
               pa.array(_strings(rng, 50, 9))])}[case]()
    assert np.array_equal(Bloom.hash_column(arr), RBloom.hash_column(arr))


@pytest.mark.parametrize("positions", [
    [], [0], [5, 65535, 65536, 2 ** 32 - 1], list(range(4095)),
    list(range(4096)), list(range(4097)), list(range(0, 300_000, 3)),
    "random"])
def test_roaring_serialize_equals_reference(positions):
    if positions == "random":
        rng = np.random.default_rng(9)
        positions = rng.integers(0, 1 << 22, 200_000)   # unsorted, dups
    pos = np.asarray(positions, dtype=np.uint64)
    assert R.serialize_roaring32(pos) == RR.serialize_roaring32(pos)


# -- cross-package deserialization --------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_blobs_read_across_packages(kind):
    t = _table(kind)
    for build, read, other in ((FI.build_indexes_blob, RFI.read_indexes_blob,
                                FI.read_indexes_blob),
                               (RFI.build_indexes_blob, FI.read_indexes_blob,
                                RFI.read_indexes_blob)):
        blob = build(t, _spec(kind))
        a, b = read(blob).by_column, other(blob).by_column
        assert set(a) == set(b)
        for col in a:
            assert set(a[col]) == set(b[col])
            for tag in a[col]:
                assert a[col][tag].serialize() == b[col][tag].serialize()


def test_v1_blob_read_across_packages():
    t = _table("int64")
    for blob in (Bloom.build_file_index(t, ["c"]),
                 RBloom.build_file_index(t, ["c"])):
        for read in (FI.read_indexes_blob, RFI.read_indexes_blob):
            fi = read(blob)
            assert list(fi.by_column) == ["c"]
        assert {k: v.serialize() for k, v in
                Bloom.read_file_index(blob).items()} == \
            {k: v.serialize() for k, v in
             RBloom.read_file_index(blob).items()}


class _MemIO:
    """read_range and read_ranges over an in-memory file, counting the
    reads; after `swap_after` reads the file holds `swap` instead (a
    sidecar replaced under the same name)."""

    def __init__(self, data, swap=None, swap_after=None):
        self.data = data
        self.swap, self.swap_after = swap, swap_after
        self.reads = []

    def _tick(self):
        if self.swap is not None and len(self.reads) == self.swap_after:
            self.data = self.swap

    def read_range(self, path, offset, length):
        self._tick()
        self.reads.append((offset, length))
        return self.data[offset:offset + length]

    def read_ranges(self, path, ranges):
        self._tick()
        self.reads.append(tuple(ranges))
        return [self.data[o:o + n] for o, n in ranges]


def _sidecar_table():
    rng = np.random.default_rng(4)
    return pa.table({
        "a": pa.array(rng.integers(0, 1 << 40, 5000)),
        "b": pa.array(rng.integers(0, 100, 5000).astype(np.int32)),
        "c": pa.array(rng.integers(0, 1 << 30, 5000)),
        "s": pa.array([f"n{i % 70}" for i in range(5000)])})


def _serialized(fi, columns):
    return {c: {k: v.serialize() for k, v in (fi.column(c) or {}).items()}
            for c in columns}


@pytest.mark.parametrize("window", [8, 64, 1 << 16])
def test_ranged_sidecar_read_equals_whole_read(window, monkeypatch):
    monkeypatch.setattr(FI, "SIDECAR_WINDOW", window)
    blob = FI.build_indexes_blob(_sidecar_table(), {
        "bloom-filter": ["a"], "bitmap": ["b"], "bsi": ["b"],
        "range-bitmap": ["c"]})
    whole = FI.read_indexes_blob(blob)
    for asked in (["a"], ["b", "c"], ["a", "b", "c", "absent"]):
        io = _MemIO(blob)
        fi = FI.read_indexes_file(io, "x", asked)
        assert _serialized(fi, asked) == _serialized(whole, asked)
        if window < len(blob):
            # only the asked-for columns are read beyond the headers
            assert set(fi.by_column) == set(asked) - {"absent"}


@pytest.mark.parametrize("swap_after", [0, 1, 2, 3, 4, 5])
def test_sidecar_replaced_between_reads(swap_after, monkeypatch):
    """A sidecar replaced by another spec's blob while it is read by
    ranges reads as the old blob, the new one, or no index, never as
    the new bytes at the old offsets."""
    t = _sidecar_table()
    old = FI.build_indexes_blob(t, {"bloom-filter": ["a"], "bitmap": ["b"],
                                    "range-bitmap": ["c"]})
    new = FI.build_indexes_blob(t, {"bloom-filter": ["s", "a"],
                                    "bsi": ["b"], "bitmap": ["c", "b"]})
    asked = ["a", "b", "c"]
    monkeypatch.setattr(FI, "SIDECAR_WINDOW", 64)
    io = _MemIO(old, swap=new, swap_after=swap_after)
    got = _serialized(FI.read_indexes_file(io, "x", asked), asked)
    assert got in (_serialized(FI.read_indexes_blob(old), asked),
                   _serialized(FI.read_indexes_blob(new), asked),
                   _serialized(FI.FileIndexes(), asked))
    if swap_after >= len(io.reads):           # read before the swap
        assert got == _serialized(FI.read_indexes_blob(old), asked)


# -- evaluation ---------------------------------------------------------------

def _literals(kind, col):
    vals = [v for v in col.to_pylist() if v is not None]
    if not vals:
        return [5, 6, 7]
    vals = sorted(vals, key=lambda v: (v != v, v))   # NaN last
    picks = [vals[0], vals[len(vals) // 2], vals[-1]]
    if kind in ("int8", "int16", "int32", "int64", "single", "wide"):
        picks += [vals[0] - 1, vals[-1] + 1, 0]
    if kind in ("float32", "double_nan"):
        picks += [0.0, -1e9, 1e9, float("nan")]
    if kind == "string":
        picks += ["", "w", "w1", "zzz", "a"]
    return picks


_OPS = ["eq", "ne", "lt", "le", "gt", "ge", "is_null", "is_not_null"]


def _mask_eq(a, b):
    (ma, ea), (mb, eb) = a, b
    assert ea == eb
    assert (ma is None) == (mb is None)
    if ma is not None:
        assert np.array_equal(ma, mb)


@pytest.mark.parametrize("kind", KINDS)
def test_eval_masks_equal_reference(kind):
    col = pa.chunked_array([_table(kind).column("c").combine_chunks()])
    lits = _literals(kind, col.combine_chunks())
    for port, ref in ((B.BitmapIndex, RB.BitmapIndex),
                      (B.BSIIndex, RB.BSIIndex),
                      (B.RangeBitmapIndex, RB.RangeBitmapIndex)):
        try:
            r = ref.build(col)
        except (ValueError, NotImplementedError):
            continue
        if r is None:
            continue
        p = port.build(col)
        assert p.serialize() == r.serialize()
        for op in _OPS:
            for lit in lits:
                _mask_eq(p.eval(op, lit), r.eval(op, lit))
        for lo, hi in ((lits[0], lits[1]), (lits[1], lits[0])):
            _mask_eq(p.eval("between", (lo, hi)), r.eval("between",
                                                          (lo, hi)))
        _mask_eq(p.eval("in", lits[:3]), r.eval("in", lits[:3]))
        _mask_eq(p.eval("not_in", lits[:2]), r.eval("not_in", lits[:2]))
        if kind == "string":
            for prefix in ("w", "w1", "", "a", "\U0010FFFF", "zz"):
                _mask_eq(p.eval("starts_with", prefix),
                         r.eval("starts_with", prefix))


def _preds(pkg, lits):
    a, b = lits[0], lits[1]
    return [pkg.equal("c", a), pkg.equal("c", b), pkg.not_equal("c", a),
            pkg.less_than("c", b), pkg.less_or_equal("c", a),
            pkg.greater_than("c", b), pkg.greater_or_equal("c", a),
            pkg.between("c", a, b), pkg.in_("c", lits[:3]),
            pkg.is_null("c"), pkg.is_not_null("c"),
            pkg.and_(pkg.equal("c", a), pkg.greater_than("c", b)),
            pkg.or_(pkg.equal("c", a), pkg.less_than("c", b)),
            pkg.not_(pkg.equal("c", a))]


@pytest.mark.parametrize("kind", KINDS)
def test_evaluate_skip_and_row_selection_equal_reference(kind):
    t = _table(kind)
    blob = RFI.build_indexes_blob(t, _spec(kind))
    types = {"c": t.column("c").type}
    lits = _literals(kind, t.column("c").combine_chunks())
    for lit_set in (lits, lits[2:] + lits[:2], [lits[-1]] * 3):
        for pp, rp in zip(_preds(P, lit_set), _preds(RefP, lit_set)):
            got = FI.evaluate_skip(FI.read_indexes_blob(blob), pp, types)
            want = RFI.evaluate_skip(RFI.read_indexes_blob(blob), rp, types)
            assert got == want, (pp, lit_set)
            gs = FI.row_selection(FI.read_indexes_blob(blob), pp,
                                  t.num_rows, types)
            ws = RFI.row_selection(RFI.read_indexes_blob(blob), rp,
                                   t.num_rows, types)
            assert (gs is None) == (ws is None)
            if ws is not None:
                assert np.array_equal(gs, ws)


# -- the reference's own cases, on the port -----------------------------------

def test_bloom_roundtrip_and_fpp():
    rng = np.random.default_rng(3)
    col = pa.chunked_array([pa.array(rng.integers(0, 1 << 40, 10_000),
                                     pa.int64())])
    hashes = Bloom.hash_column(col)
    bf = Bloom.BloomFilter.deserialize(
        Bloom.BloomFilter.build(hashes, fpp=0.01).serialize())
    assert all(bf.might_contain(int(h)) for h in hashes[:200])
    assert bf.might_contain_many(hashes).all()
    probe = Bloom.hash_column(pa.chunked_array(
        [pa.array(rng.integers(1 << 41, 1 << 42, 2000), pa.int64())]))
    fp = sum(bf.might_contain(int(h)) for h in probe)
    assert fp < 2000 * 0.05
    assert fp == int(bf.might_contain_many(probe).sum())


def test_bloom_string_column():
    col = pa.chunked_array([pa.array(["alpha", "beta", None, "gamma"])])
    bf = Bloom.BloomFilter.build(Bloom.hash_column(col))
    assert bf.might_contain(Bloom.hash_value("beta", pa.string()))
    assert not bf.might_contain(Bloom.hash_value("nope-nope-nope",
                                                 pa.string()))


def test_file_index_blob_roundtrip():
    t = pa.table({"a": pa.array([1, 2, 3], pa.int64()),
                  "b": pa.array(["x", "y", "z"])})
    idx = Bloom.read_file_index(Bloom.build_file_index(t, ["a", "b"]))
    assert set(idx) == {"a", "b"}
    assert idx["a"].might_contain(Bloom.hash_value(2, pa.int64()))
    assert not idx["a"].might_contain(Bloom.hash_value(99, pa.int64()))


class TestBitmapIndex:
    VALS = [3, 1, None, 3, 7, 1, 9, None, 3, 5]

    def _idx(self, vals=None, typ=pa.int64()):
        col = pa.chunked_array([pa.array(vals or self.VALS, typ)])
        return B.BitmapIndex.deserialize(B.BitmapIndex.build(col).serialize())

    @pytest.mark.parametrize("op, lit, want", [
        ("eq", 3, [0, 3, 8]), ("eq", 4, []), ("in", [1, 9], [1, 5, 6]),
        ("is_null", None, [2, 7])])
    def test_exact_positions(self, op, lit, want):
        m, exact = self._idx().eval(op, lit)
        assert exact and _positions(m) == want

    @pytest.mark.parametrize("op, lit, fn", [
        ("ne", 3, lambda v: v != 3),
        ("not_in", [1, 9], lambda v: v not in (1, 9)),
        ("is_not_null", None, lambda v: True),
        ("lt", 5, lambda v: v < 5), ("le", 5, lambda v: v <= 5),
        ("gt", 3, lambda v: v > 3), ("ge", 3, lambda v: v >= 3),
        ("between", (3, 7), lambda v: 3 <= v <= 7)])
    def test_ops(self, op, lit, fn):
        m, exact = self._idx().eval(op, lit)
        assert exact and _positions(m) == _expected(self.VALS, fn)

    @pytest.mark.parametrize("vals, op, lit, want", [
        (["apple", "banana", None, "apricot", "cherry", "apple"], "eq",
         "apple", [0, 5]),
        (["apple", "banana", None, "apricot", "cherry", "apple"],
         "starts_with", "ap", [0, 3, 5]),
        (["a\U0001F600", "ab", "b"], "starts_with", "a", [0, 1]),
        (["foo", "foo\U0010FFFFx", "foobar", "fop"], "starts_with", "foo",
         [0, 1, 2])])
    def test_strings(self, vals, op, lit, want):
        m, exact = self._idx(vals, pa.string()).eval(op, lit)
        assert exact and _positions(m) == want

    def test_high_cardinality_declines(self):
        col = pa.chunked_array([pa.array(list(range(100)), pa.int64())])
        assert B.BitmapIndex.build(col, max_distinct=50) is None


class TestBSIIndex:
    VALS = [100, -3, None, 42, 0, 7, -3, 99999, None, 100]

    def _idx(self):
        col = pa.chunked_array([pa.array(self.VALS, pa.int64())])
        return B.BSIIndex.deserialize(B.BSIIndex.build(col).serialize())

    @pytest.mark.parametrize("op,lit,fn", [
        ("eq", 100, lambda v: v == 100), ("ne", 100, lambda v: v != 100),
        ("lt", 42, lambda v: v < 42), ("le", 42, lambda v: v <= 42),
        ("gt", 0, lambda v: v > 0), ("ge", 0, lambda v: v >= 0),
        ("lt", -100, lambda v: False), ("gt", 10 ** 7, lambda v: False),
        ("le", 10 ** 7, lambda v: True),
        ("between", (-3, 100), lambda v: -3 <= v <= 100)])
    def test_ops(self, op, lit, fn):
        m, exact = self._idx().eval(op, lit)
        assert exact and _positions(m) == _expected(self.VALS, fn)

    def test_nulls_and_floats(self):
        m, _ = self._idx().eval("is_null", None)
        assert _positions(m) == [2, 8]
        col = pa.chunked_array([pa.array([1.5, 2.5], pa.float64())])
        assert B.BSIIndex.build(col) is None

    def test_randomized_vs_numpy(self):
        rng = np.random.default_rng(3)
        vals = rng.integers(-10 ** 6, 10 ** 6, 500).tolist()
        col = pa.chunked_array([pa.array(vals, pa.int64())])
        idx = B.BSIIndex.deserialize(B.BSIIndex.build(col).serialize())
        for c in [-10 ** 6, -12345, 0, 54321, 10 ** 6]:
            m, _ = idx.eval("le", c)
            assert _positions(m) == _expected(vals, lambda v: v <= c)


class TestRangeBitmapIndex:
    @pytest.mark.parametrize("seed, lo, hi", [(11, 0, 10 ** 4),
                                              (5, -1000, 1000)])
    def test_superset_semantics(self, seed, lo, hi):
        rng = np.random.default_rng(seed)
        vals = rng.integers(lo, hi, 1000).tolist()
        col = pa.chunked_array([pa.array(vals, pa.int64())])
        idx = B.RangeBitmapIndex.deserialize(
            B.RangeBitmapIndex.build(col).serialize())
        for c in (lo, (lo + hi) // 2 - 1, (lo + hi) // 2, hi, vals[0]):
            for op, fn in [("lt", lambda v: v < c), ("le", lambda v: v <= c),
                           ("ge", lambda v: v >= c), ("gt", lambda v: v > c),
                           ("eq", lambda v: v == c)]:
                m, _ = idx.eval(op, c)
                assert set(_expected(vals, fn)) <= set(_positions(m))
        m, _ = idx.eval("between", (lo + 100, lo + 200))
        assert set(_expected(vals, lambda v: lo + 100 <= v <= lo + 200)) \
            <= set(_positions(m))

    @pytest.mark.parametrize("op, lit", [("gt", 1000), ("lt", 5)])
    def test_out_of_range_skips(self, op, lit):
        col = pa.chunked_array([pa.array([10, 20, 30], pa.int64())])
        m, _ = B.RangeBitmapIndex.build(col).eval(op, lit)
        assert not m.any()

    def test_all_null_column(self):
        col = pa.chunked_array([pa.array([None, None, None], pa.int64())])
        idx = B.RangeBitmapIndex.deserialize(
            B.RangeBitmapIndex.build(col).serialize())
        for op, lit in [("eq", 5), ("lt", 5), ("le", 5), ("gt", 5),
                        ("ge", 5), ("between", (1, 9))]:
            m, _ = idx.eval(op, lit)
            assert m is None or not m.any(), op
        m, _ = idx.eval("is_null", None)
        assert _positions(m) == [0, 1, 2]


def test_blob_round_trip_multi_index():
    t = pa.table({
        "a": pa.array([1, 2, 2, 3], pa.int64()),
        "b": pa.array(["x", "y", None, "x"], pa.string()),
        "c": pa.array([10, 20, 30, 40], pa.int64()),
    })
    blob = FI.build_indexes_blob(t, {"bloom-filter": ["a"],
                                     "bitmap": ["b"], "bsi": ["c"],
                                     "range-bitmap": ["c"]})
    fi = FI.read_indexes_blob(blob)
    assert set(fi.by_column) == {"a", "b", "c"}
    assert len(fi.by_column["c"]) == 2
    assert FI.evaluate_skip(fi, P.equal("b", "zzz"), {})
    assert not FI.evaluate_skip(fi, P.equal("b", "x"), {})
    assert FI.evaluate_skip(fi, P.greater_than("c", 100), {})
    assert FI.evaluate_skip(fi, P.and_(P.equal("b", "y"),
                                       P.greater_than("c", 35)), {})
    assert not FI.evaluate_skip(fi, P.or_(P.equal("b", "zzz"),
                                          P.less_than("c", 15)), {})
    assert _positions(FI.row_selection(fi, P.equal("b", "x"), 4, {})) == \
        [0, 3]


def test_v1_bloom_blob_still_readable():
    t = pa.table({"a": pa.array([1, 2, 3], pa.int64())})
    fi = FI.read_indexes_blob(Bloom.build_file_index(t, ["a"]))
    assert "a" in fi.by_column
    assert FI.evaluate_skip(fi, P.equal("a", 999999), {"a": pa.int64()})
    assert not FI.evaluate_skip(fi, P.equal("a", 2), {"a": pa.int64()})
