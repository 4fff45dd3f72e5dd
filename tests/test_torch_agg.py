"""paimon_tpu_torch.ops.agg against paimon_tpu.ops.agg.

The same KV-shaped runs, made with numpy from a seed, go through the
reference's `merge_runs_agg` (on its host merge path, and on its device
path pinned by PAIMON_FORCE_DEVICE_SORT=1: Pallas in interpret mode) and
through the port's (device="cpu": torch ops and the kernel's plain
version).  Results are exact, bit for bit on floats (NaN and -0.0
included), except float sum and product: those agree within rtol 1e-12
(float64) and 1e-5 (float32), since a float sum's last bits depend on
the order of its additions.  Where the reference raises, the port must
raise the same exception type.  The segment reductions are also held
one by one against the reference's `_seg_*`.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from paimon_tpu.index.roaring import serialize_roaring32, serialize_roaring64
from paimon_tpu.ops import agg as ref
from paimon_tpu.ops.sketch import hll_build, theta_build
from paimon_tpu.options import CoreOptions as RefCoreOptions
from paimon_tpu.options import Options as RefOptions
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.schema.table_schema import TableSchema as RefTableSchema
from paimon_tpu.types import parse_type_string as ref_type
from paimon_tpu_torch.ops import agg
from paimon_tpu_torch.options import CoreOptions, Options
from paimon_tpu_torch.schema import Schema, TableSchema
from paimon_tpu_torch.types import RowKind
from paimon_tpu_torch.types import parse_type_string as port_type

KEY, SEQ, KIND = "_KEY_k", agg.SEQ_COL, agg.KIND_COL
FLOAT_RTOL = {pa.float64(): 1e-12, pa.float32(): 1e-5}


@pytest.fixture(params=["host", "device"])
def ref_path(request, monkeypatch):
    """The reference's host merge path, or its device path (Pallas in
    interpret mode on the CPU)."""
    monkeypatch.setenv("PAIMON_FORCE_HOST_SORT" if request.param == "host"
                       else "PAIMON_FORCE_DEVICE_SORT", "1")
    return request.param


def schemas(columns, options, key_type="BIGINT NOT NULL"):
    """[(TableSchema, CoreOptions)] of the reference and of the port for
    key `k` plus `columns` [(name, type string)]."""
    out = []
    for builder, table_schema, core, opts, parse in (
            (RefSchema, RefTableSchema, RefCoreOptions, RefOptions, ref_type),
            (Schema, TableSchema, CoreOptions, Options, port_type)):
        b = builder.builder().column("k", parse(key_type))
        for name, t in columns:
            b = b.column(name, parse(t))
        ts = table_schema.from_schema(0, b.primary_key("k")
                                      .options(dict(options)).build())
        out.append((ts, core(opts(dict(ts.options)))))
    return out


def make_runs(seed, columns, gens, n_runs=3, rows=220, n_keys=120,
              retract_p=0.15, string_keys=False):
    """`n_runs` (key, seq)-sorted KV runs, oldest first: uniform keys,
    increasing sequence numbers, 1 row in ~7 a DELETE or UPDATE_BEFORE
    retract (some UPDATE_AFTER), and each value column from its
    generator gens[name](rng, n) -> pa.Array."""
    rng = np.random.default_rng(seed)
    runs, seq0 = [], 0
    for _ in range(n_runs):
        keys = rng.integers(0, n_keys, rows)
        if string_keys:
            # every third key longer than the 16-byte lane prefix, with a
            # shared prefix, so the truncated-key repair runs
            k = pa.array([("k" * 20 + f"{v:05d}") if v % 3 == 0
                          else f"s{v:05d}" for v in keys.tolist()])
        else:
            k = pa.array(keys, pa.int64())
        u = rng.random(rows)
        kinds = np.where(u < retract_p / 2, RowKind.DELETE,
                         np.where(u < retract_p, RowKind.UPDATE_BEFORE,
                                  np.where(u < retract_p + 0.05,
                                           RowKind.UPDATE_AFTER,
                                           RowKind.INSERT))).astype(np.int8)
        cols = {KEY: k,
                SEQ: pa.array(np.arange(seq0, seq0 + rows), pa.int64()),
                KIND: pa.array(kinds, pa.int8()), "k": k}
        for name, _ in columns:
            cols[name] = gens[name](rng, rows)
        seq0 += rows
        t = pa.table(cols)
        runs.append(t.take(pc.sort_indices(
            t, sort_keys=[(KEY, "ascending"), (SEQ, "ascending")])))
    return runs


def assert_same_table(got, want, approx=()):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        assert g.type == w.type, name
        if not pa.types.is_floating(w.type):
            assert g.equals(w), name
            continue
        assert pc.is_valid(g).equals(pc.is_valid(w)), name
        gv = np.asarray(g.fill_null(0))
        wv = np.asarray(w.fill_null(0))
        both_nan = np.isnan(gv) & np.isnan(wv)
        if name in approx:
            np.testing.assert_allclose(gv[~both_nan], wv[~both_nan],
                                       rtol=FLOAT_RTOL[w.type], err_msg=name)
            assert (np.isnan(gv) == np.isnan(wv)).all(), name
        else:
            itype = np.uint64 if wv.dtype == np.float64 else np.uint32
            same = (gv.view(itype) == wv.view(itype)) | both_nan
            assert same.all(), (name, gv[~same], wv[~same])


def run_both(runs, columns, options, approx=(), key_type="BIGINT NOT NULL",
             seq_fields=None):
    (rts, rco), (pts, pco) = schemas(columns, options, key_type)
    try:
        want = ref.merge_runs_agg(runs, [KEY], rts, rco,
                                  seq_fields=seq_fields)
    except Exception as e:          # noqa: BLE001
        with pytest.raises(type(e)):
            agg.merge_runs_agg(runs, [KEY], pts, pco, seq_fields=seq_fields,
                               device="cpu")
        return None
    got = agg.merge_runs_agg(runs, [KEY], pts, pco, seq_fields=seq_fields,
                             device="cpu")
    assert_same_table(got, want, approx)
    return got


# -- generators ---------------------------------------------------------------

def with_nulls(arr_fn, p=0.2):
    """Generator of arr_fn's numpy values with a share `p` of nulls."""
    def gen(rng, n):
        return pa.array(arr_fn(rng, n), mask=rng.random(n) < p)
    return gen


def ints(dtype, lo=-3, hi=4):
    return with_nulls(lambda rng, n: rng.integers(lo, hi, n).astype(dtype))


def product_ints(dtype):
    # mostly 1, sometimes -1 or 2: products stay inside the narrowest type
    return with_nulls(lambda rng, n: rng.choice(
        np.array([1, 1, 1, -1, 2], dtype=dtype), n))


def floats(dtype):
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=dtype)

    def values(rng, n):
        v = (rng.standard_normal(n) * 4).astype(dtype)
        pick = rng.random(n) < 0.15
        v[pick] = specials[rng.integers(0, len(specials), pick.sum())]
        return v
    return with_nulls(values)


def bools(rng, n):
    return pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2)


NUMERIC = {"TINYINT": np.int8, "SMALLINT": np.int16, "INT": np.int32,
           "BIGINT": np.int64, "FLOAT": np.float32, "DOUBLE": np.float64,
           "BOOLEAN": bool}


def numeric_gen(type_name, func):
    dtype = NUMERIC[type_name]
    if dtype is bool:
        return bools
    if np.issubdtype(dtype, np.floating):
        return floats(dtype)
    return product_ints(dtype) if func == "product" else ints(dtype)


# -- every numeric aggregate on every dtype of the reference's map ------------

@pytest.mark.parametrize("func", ["sum", "max", "min", "product", "count"])
@pytest.mark.parametrize("type_name", list(NUMERIC))
def test_numeric_aggregates_match_reference(ref_path, type_name, func):
    # BOOLEAN: the reference's fill_null(0) on a bool column raises
    # ArrowInvalid, and the port must raise it too
    cols = [("v", type_name)]
    runs = make_runs(3, cols, {"v": numeric_gen(type_name, func)})
    approx = ("v",) if func in ("sum", "product") and \
        type_name in ("FLOAT", "DOUBLE") else ()
    run_both(runs, cols, {"merge-engine": "aggregation",
                          "fields.v.aggregate-function": func}, approx)


@pytest.mark.parametrize("type_name", ["INT", "DOUBLE"])
def test_ignore_retract_sum_matches_reference(ref_path, type_name):
    cols = [("a", type_name), ("b", type_name)]
    gen = numeric_gen(type_name, "sum")
    runs = make_runs(5, cols, {"a": gen, "b": gen}, retract_p=0.4)
    run_both(runs, cols, {"merge-engine": "aggregation",
                          "fields.a.aggregate-function": "sum",
                          "fields.b.aggregate-function": "sum",
                          "fields.b.ignore-retract": "true"},
             approx=("a", "b") if type_name == "DOUBLE" else ())


# -- order-based and host aggregates ------------------------------------------

def strings(rng, n):
    return pa.array([f"s{v}" for v in rng.integers(0, 50, n)],
                    mask=rng.random(n) < 0.2)


def string_lists(rng, n):
    return pa.array([[f"t{v}" for v in rng.integers(0, 4, rng.integers(0, 3))]
                     for _ in range(n)], pa.list_(pa.string()),
                    mask=rng.random(n) < 0.2)


def maps(rng, n):
    return pa.array([[(f"m{k}", int(v)) for k, v in
                      zip(rng.integers(0, 4, 2), rng.integers(0, 9, 2))]
                     for _ in range(n)], pa.map_(pa.string(), pa.int32()),
                    mask=rng.random(n) < 0.2)


def bitmaps(width):
    def gen(rng, n):
        ser = serialize_roaring32 if width == 32 else serialize_roaring64
        dt = np.uint32 if width == 32 else np.uint64
        base = 0 if width == 32 else 1 << 40
        return pa.array([bytes(ser(np.unique(
            rng.integers(0, 5000, rng.integers(1, 6)).astype(dt) + dt(base))))
            for _ in range(n)], pa.binary(), mask=rng.random(n) < 0.2)
    return gen


def sketches(build):
    def gen(rng, n):
        return pa.array([build(pa.array(rng.integers(0, 10_000, 30),
                                        pa.int64())) for _ in range(n)],
                        pa.binary(), mask=rng.random(n) < 0.2)
    return gen


def nested_rows(rng, n):
    return pa.array([[{"oid": int(o), "st": f"st{int(s)}"} for o, s in
                      zip(rng.integers(0, 4, 2), rng.integers(0, 3, 2))]
                     for _ in range(n)],
                    pa.list_(pa.struct([("oid", pa.int64()),
                                        ("st", pa.string())])),
                    mask=rng.random(n) < 0.2)


NESTED = "ARRAY<ROW<oid BIGINT, st STRING>>"
HOST_CASES = {
    "last_value": ("INT", ints(np.int32), {}),
    "last_non_null_value": ("STRING", strings, {}),
    "first_value": ("STRING", strings, {}),
    "first_non_null_value": ("INT", ints(np.int32), {}),
    "primary_key": ("INT", ints(np.int32), {}),
    "listagg": ("STRING", strings,
                {"fields.v.list-agg-delimiter": "|"}),
    "collect": ("ARRAY<STRING>", string_lists, {}),
    "collect-distinct": ("ARRAY<STRING>", string_lists,
                         {"fields.v.distinct": "true"}),
    "merge_map": ("MAP<STRING, INT>", maps, {}),
    "rbm32": ("BYTES", bitmaps(32), {}),
    "rbm64": ("BYTES", bitmaps(64), {}),
    "hll_sketch": ("BYTES", sketches(hll_build), {}),
    "theta_sketch": ("BYTES", sketches(theta_build), {}),
    "nested_update": (NESTED, nested_rows, {}),
    "nested_update-keyed": (NESTED, nested_rows,
                            {"fields.v.nested-key": "oid"}),
    "bool_and": ("BOOLEAN", bools, {}),
    "bool_or": ("BOOLEAN", bools, {}),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_order_and_host_aggregates_match_reference(ref_path, case):
    type_name, gen, extra = HOST_CASES[case]
    cols = [("v", type_name)]
    runs = make_runs(7, cols, {"v": gen}, rows=120, n_keys=60)
    run_both(runs, cols, {"merge-engine": "aggregation",
                          "fields.v.aggregate-function": case.split("-")[0],
                          **extra})


@pytest.mark.parametrize("options, columns", [
    ({"fields.v.aggregate-function": "sum"}, [("v", "DECIMAL(10, 2)")]),
    ({"fields.v.aggregate-function": "collect"}, [("v", "STRING")]),
    ({"fields.v.aggregate-function": "no_such_function"}, [("v", "INT")]),
    ({"fields.v.aggregate-function": "nested_update",
      "fields.v.nested-key": "nope"}, [("v", NESTED)])],
    ids=["decimal-sum", "collect-not-array", "unknown", "bad-nested-key"])
def test_errors_match_reference(ref_path, options, columns):
    gens = {"DECIMAL(10, 2)": lambda rng, n: pa.array(
                [None] * n, pa.decimal128(10, 2)),
            "STRING": strings, "INT": ints(np.int32), NESTED: nested_rows}
    runs = make_runs(9, columns, {"v": gens[columns[0][1]]}, rows=40)
    (rts, rco), (pts, pco) = schemas(columns, {"merge-engine": "aggregation",
                                               **options})
    with pytest.raises(Exception) as want:
        ref.merge_runs_agg(runs, [KEY], rts, rco)
    with pytest.raises(want.type):
        agg.merge_runs_agg(runs, [KEY], pts, pco, device="cpu")


# -- keys, sequence fields, engines -------------------------------------------

def test_long_string_keys_match_reference(ref_path):
    """Keys longer than the 16-byte lane prefix: the device segments
    over-group them and the host repair splits them again."""
    cols = [("a", "BIGINT"), ("b", "STRING")]
    runs = make_runs(11, cols, {"a": ints(np.int64), "b": strings},
                     string_keys=True)
    run_both(runs, cols, {"merge-engine": "aggregation",
                          "fields.a.aggregate-function": "sum",
                          "fields.b.aggregate-function": "last_value"},
             key_type="STRING NOT NULL")


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("engine", ["aggregation", "partial-update"])
def test_user_sequence_field_matches_reference(ref_path, engine, order):
    cols = [("v", "INT"), ("w", "DOUBLE"), ("ts", "BIGINT")]
    runs = make_runs(13, cols, {"v": ints(np.int32),
                                "w": floats(np.float64),
                                "ts": ints(np.int64, 0, 50)})
    options = {"merge-engine": engine, "sequence.field": "ts",
               "sequence.field.sort-order": order}
    if engine == "aggregation":
        options.update({"fields.v.aggregate-function": "last_value",
                        "fields.w.aggregate-function": "max"})
    run_both(runs, cols, options, seq_fields=["ts"])


@pytest.mark.parametrize("extra", [
    {},
    {"partial-update.remove-record-on-delete": "true"},
    {"fields.g.sequence-group": "a,b"},
    {"fields.g.sequence-group": "a,b", "fields.c.aggregate-function": "sum",
     "fields.n.aggregate-function": "count"}],
    ids=["plain", "remove-on-delete", "sequence-group", "group-and-aggs"])
def test_partial_update_matches_reference(ref_path, extra):
    cols = [("a", "INT"), ("b", "STRING"), ("g", "INT"), ("c", "DOUBLE"),
            ("n", "INT")]
    runs = make_runs(17, cols, {"a": ints(np.int32), "b": strings,
                                "g": ints(np.int32, 0, 20),
                                "c": floats(np.float64),
                                "n": ints(np.int32)})
    run_both(runs, cols, {"merge-engine": "partial-update", **extra},
             approx=("c",))


def test_default_aggregate_function_matches_reference(ref_path):
    cols = [("a", "BIGINT"), ("b", "FLOAT"), ("c", "INT")]
    runs = make_runs(19, cols, {"a": ints(np.int64), "b": floats(np.float32),
                                "c": ints(np.int32)})
    run_both(runs, cols, {"merge-engine": "aggregation",
                          "fields.default-aggregate-function": "max",
                          "fields.c.aggregate-function": "min"})


def test_encoded_runs_match_unencoded():
    """Streamed compaction windows hand over their lane encoding; the
    result equals the merge that encodes the runs itself."""
    from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
    cols = [("v", "BIGINT")]
    runs = make_runs(23, cols, {"v": ints(np.int64)})
    (_, _), (pts, pco) = schemas(cols, {"merge-engine": "aggregation",
                                        "fields.v.aggregate-function": "sum"})
    enc = NormalizedKeyEncoder([pa.int64()], nullable=[False])
    encoded = [enc.encode_table_ex(r, [KEY]) for r in runs]
    a = agg.merge_runs_agg(runs, [KEY], pts, pco, key_encoder=enc,
                           encoded=encoded, device="cpu")
    b = agg.merge_runs_agg(runs, [KEY], pts, pco, device="cpu")
    assert a.equals(b)


# -- the segment reductions one by one ----------------------------------------

def sorted_segments(rng, n):
    lengths = rng.integers(1, 9, n)
    seg = np.repeat(np.arange(n), lengths)[:n]
    return seg.astype(np.int64), int(seg[-1]) + 1


def reduction_inputs(rng, dtype, n):
    if np.issubdtype(dtype, np.floating):
        v = (rng.standard_normal(n) * 3).astype(dtype)
        specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], dtype)
        pick = rng.random(n) < 0.2
        v[pick] = specials[rng.integers(0, 5, pick.sum())]
        return v
    return rng.integers(-3, 4, n).astype(dtype)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_reduce_matches_reference(seed, dtype, op):
    rng = np.random.default_rng(seed)
    n = 3000
    seg, num = sorted_segments(rng, n)
    vals = reduction_inputs(rng, dtype, n)
    # -0.0 and +0.0 alone and together in both orders, and a NaN next
    # to either zero, in segments of their own
    if np.issubdtype(dtype, np.floating):
        vals[:8] = [-0.0, 0.0, 0.0, -0.0, -0.0, -0.0, np.nan, -0.0]
        seg[:8] = [0, 0, 1, 1, 2, 2, 3, 3]
        seg[8:] = np.maximum(seg[8:], 4)
        seg = np.unique(seg, return_inverse=True)[1].astype(np.int64)
        num = int(seg[-1]) + 1
    want = np.asarray({"sum": ref._seg_sum, "max": ref._seg_max,
                       "min": ref._seg_min,
                       "prod": ref._seg_prod}[op](vals, seg, num))
    got = agg.segment_reduce(vals, op, agg.Segments(seg, num, "cpu"))
    assert got.dtype == want.dtype
    if np.issubdtype(dtype, np.floating) and op in ("sum", "prod"):
        np.testing.assert_allclose(got, want, equal_nan=True,
                                   rtol=1e-12 if dtype == np.float64
                                   else 1e-5)
        assert (np.signbit(got) == np.signbit(want))[want == 0].all()
    elif np.issubdtype(dtype, np.floating):
        itype = np.uint64 if dtype == np.float64 else np.uint32
        same = (got.view(itype) == want.view(itype)) | \
            (np.isnan(got) & np.isnan(want))
        assert same.all(), (got[~same], want[~same])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["first", "last"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_where_matches_reference(seed, which):
    rng = np.random.default_rng(seed)
    seg, num = sorted_segments(rng, 2500)
    mask = rng.random(len(seg)) < 0.3
    segs = agg.Segments(seg, num, "cpu")
    if which == "first":
        want = ref._first_index_where(mask, seg, num)
        got = agg._first_index_where(mask, segs)
    else:
        want = ref._last_index_where(mask, seg, num)
        got = agg._last_index_where(mask, segs)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_segment_reduce_is_deterministic():
    """Two runs of a float sum give the same bits."""
    rng = np.random.default_rng(3)
    seg, num = sorted_segments(rng, 5000)
    vals = rng.standard_normal(len(seg))
    segs = agg.Segments(seg, num, "cpu")
    a = agg.segment_reduce(vals, "sum", segs)
    b = agg.segment_reduce(vals, "sum", segs)
    assert a.tobytes() == b.tobytes()
