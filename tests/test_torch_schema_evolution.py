"""Column DDL, the cast rule matrix and schema evolution of
paimon_tpu_torch against paimon_tpu.

The cases of tests/test_schema.py and tests/test_casting.py run on both
packages: the reference's source, once as written and once with every
`paimon_tpu.` import pointed at `paimon_tpu_torch.`.  The port's
`cast_array` equals the reference's on the rule matrix's pairs.  Tables
evolved by ADD COLUMN, a widened type and a RENAME scan and compact
(whole and streamed) to the reference's rows and a numpy oracle; after a
primary-key type widening the port's rows equal the oracle where the
reference raises (ROADMAP.md C).
"""

import inspect
import os
import types

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.types as ref_types
import paimon_tpu_torch.types as port_types
from paimon_tpu.data.casting import cast_array as ref_cast
from paimon_tpu.schema import SchemaChange as RefChange
from paimon_tpu_torch.data.casting import cast_array as port_cast
from paimon_tpu_torch.schema import SchemaChange
from tests.test_torch_dynamic_bucket import PORT, REF, commit_arrow

HERE = os.path.dirname(os.path.abspath(__file__))
CASE_FILES = ("test_schema", "test_casting")


def _load(name: str, port: bool):
    """A reference test module, run as written or against the port."""
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as f:
        src = f.read()
    if port:
        src = src.replace("paimon_tpu.", "paimon_tpu_torch.") \
            .replace("from paimon_tpu import", "from paimon_tpu_torch import")
    mod = types.ModuleType(f"{name}_{'port' if port else 'reference'}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _case_names(name: str):
    with open(os.path.join(HERE, f"{name}.py")) as f:
        return [line[4:line.index("(")] for line in f
                if line.startswith("def test_")]


CASES = [(f, c) for f in CASE_FILES for c in _case_names(f)]


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[f"{f}.{c}" for f, c in CASES])
def test_reference_case(tmp_path, case, pkg):
    mod = _load(case[0], pkg == "port")
    fn = getattr(mod, case[1])
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p == "manager":
            kwargs[p] = mod.SchemaManager(mod.LocalFileIO(),
                                          str(tmp_path / "t"))
        elif p == "tmp_path":
            kwargs[p] = tmp_path
        else:
            raise AssertionError(f"unknown fixture {p}")
    fn(**kwargs)


# -- cast_array against the reference ----------------------------------------

def _pairs(T):
    S = T.VarCharType.string_type()
    return [
        (T.TinyIntType(), T.BigIntType(), [1, -2, None, 127]),
        (T.BigIntType(), T.TinyIntType(), [300, -300, 1 << 40, None]),
        (T.IntType(), T.BigIntType(), [2**31 - 1, -2**31, None]),
        (T.IntType(), T.DoubleType(), [7, -9, None]),
        (T.DoubleType(), T.IntType(), [3.9, -3.9, 1e12, float("nan")]),
        (T.DoubleType(), T.BigIntType(), [1e19, -1e19, 2.5]),
        (T.FloatType(), T.DoubleType(), [1.5, None]),
        (T.IntType(), T.BooleanType(), [0, 3, None]),
        (T.IntType(), T.DecimalType(10, 2), [5, -7]),
        (T.IntType(), S, [5, None, -1]),
        (T.DoubleType(), S, [1.0, 2.5, None]),
        (S, T.IntType(), [" 12 ", "-3", None]),
        (S, T.DoubleType(), ["1.5", " -2 "]),
        (S, T.BooleanType(), ["true", "no", "1", None]),
        (S, T.DateType(), ["2024-02-29", None]),
        (S, T.CharType(3), ["abcdef", "a", None]),
        (T.SmallIntType(), T.IntType(), [1, -1, None]),
    ]


@pytest.mark.parametrize("k", range(len(_pairs(ref_types))))
def test_cast_array_equals_reference(k):
    src_r, dst_r, vals = _pairs(ref_types)[k]
    src_p, dst_p, _ = _pairs(port_types)[k]
    arr = pa.array(vals, ref_types.data_type_to_arrow(src_r))
    want = ref_cast(arr, src_r, dst_r)
    got = port_cast(arr, src_p, dst_p)
    assert got.type == want.type
    assert got.to_pylist() == want.to_pylist() or \
        str(got.to_pylist()) == str(want.to_pylist())     # NaN


# -- evolved tables ----------------------------------------------------------

def _bench_schema(pkg, key="BigIntType", opts=None):
    cols = [("id", key, False), ("v1", "BigIntType", True),
            ("v2", "DoubleType", True), ("v3", "IntType", True)]
    return pkg.schema(cols, options={"bucket": "2", "write-only": "true",
                                     **(opts or {})})


def _batches(seed, n=400, commits=3, key_range=600):
    rng = np.random.default_rng(seed)
    return [pa.table({
        "id": pa.array(rng.integers(0, key_range, n), pa.int64()),
        "v1": pa.array(rng.integers(-1 << 40, 1 << 40, n), pa.int64()),
        "v2": pa.array(rng.random(n), pa.float64()),
        "v3": pa.array(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                       .astype(np.int32), pa.int32())})
        for _ in range(commits)]


def _oracle(before, after):
    """Last writer per id; rows written before the evolution read with
    v4 null and v3 widened exactly; `v2` renamed `v2r`."""
    rows = {}
    for b in before:
        for r in b.to_pylist():
            rows[r["id"]] = {"id": r["id"], "v1": r["v1"], "v2r": r["v2"],
                             "v3": r["v3"], "v4": None}
    for b in after:
        for r in b.to_pylist():
            rows[r["id"]] = r
    return [rows[k] for k in sorted(rows)]


def _evolve(pkg, table, key_change=False):
    T = pkg.types
    C = SchemaChange if pkg is PORT else RefChange
    changes = [C.add_column("v4", T.DoubleType()),
               C.update_column_type("v3", T.BigIntType()),
               C.rename_column("v2", "v2r")]
    if key_change:
        changes.append(C.update_column_type("id", T.BigIntType(False)))
    table.schema_manager.commit_changes(*changes)
    return pkg.load(table.path)


def _after(batches, seed, key_type=pa.int64()):
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        out.append(pa.table({
            "id": b.column("id").cast(key_type), "v1": b.column("v1"),
            "v2r": b.column("v2"),
            "v3": pa.array(rng.integers(-1 << 40, 1 << 40, b.num_rows),
                           pa.int64()),
            "v4": pa.array(rng.random(b.num_rows), pa.float64())}))
    return out


def _rows(table):
    return sorted(table.to_arrow().to_pylist(), key=lambda r: r["id"])


@pytest.mark.parametrize("streamed", [False, True], ids=["whole", "streamed"])
def test_value_evolution_equals_reference(tmp_path, streamed):
    """ADD COLUMN v4 DOUBLE, v3 INT -> BIGINT, RENAME v2 -> v2r, then
    upserts under the new schema: the merge-on-read scan over runs of
    both schemas, the full compaction (whole, or through the streamed
    rewriter) and the scan after it equal the reference's and the
    oracle."""
    opts = {"tpu.merge.stream-threshold-rows": "64",
            "tpu.merge.chunk-rows": "32"} if streamed else {}
    before, got = _batches(31), {}
    after = _after(_batches(32, n=300, commits=2), 33)
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), _bench_schema(pkg, opts=opts))
        for b in before:
            commit_arrow(t, b)
        t = _evolve(pkg, t)
        for b in after:
            commit_arrow(t, b)
        scan = _rows(t)
        assert t.compact(full=True) is not None
        got[pkg.name] = (scan, _rows(t))
    want = _oracle(before, after)
    assert got["port"] == got["reference"] == (want, want)


@pytest.mark.parametrize("streamed", [False, True], ids=["whole", "streamed"])
def test_key_type_evolution_port_equals_oracle_where_reference_raises(
        tmp_path, streamed):
    """INT NOT NULL id widened to BIGINT: the reference copies each
    file's _KEY_id at its own type and the run concatenation raises
    ArrowInvalid; the port casts the key column like its value column,
    so the scan, the compaction (whole, or through the streamed
    rewriter) and the scan after it equal the oracle, and the reference
    reads the port's compacted table."""
    key_before = [b.set_column(0, "id", b.column("id").cast(pa.int32()))
                  for b in _batches(41, commits=2)]
    after = _after(_batches(42, n=300, commits=2), 43)
    want = _oracle(key_before, after)
    opts = {"tpu.merge.stream-threshold-rows": "64",
            "tpu.merge.chunk-rows": "32"} if streamed else {}
    tables = {}
    for pkg in (PORT, REF):
        t = pkg.create(str(tmp_path), _bench_schema(pkg, key="IntType",
                                                    opts=opts))
        for b in key_before:
            commit_arrow(t, b)
        t = _evolve(pkg, t, key_change=True)
        for b in after:
            commit_arrow(t, b)
        tables[pkg.name] = t
    with pytest.raises(pa.ArrowInvalid):
        tables["reference"].to_arrow()
    port = tables["port"]
    assert _rows(port) == want
    assert port.compact(full=True) is not None
    assert _rows(port) == want
    assert _rows(REF.load(port.path)) == want
