"""Reference faults the port repairs, each on ROADMAP C's input: the port
reads what an oracle of the writes gives, and the reference's error on
the same input is pinned, so a change on either side shows.

- C.10: a table whose levels mix formats (avro or csv over a level-0
  orc file) could not be read: `_VALUE_KIND` is int64 in an avro or csv
  file and int8 in an orc file, and the merge concatenates the runs
  without promotion.  The port casts the system columns to their
  canonical types when it reads a file.
- C.11: widening a BIGINT holding values beyond 2^53 to DOUBLE made
  every read raise (a safe Arrow cast).  The port casts as Java's
  `(double) long` does, rounding to nearest even.
"""

from __future__ import annotations

import pyarrow as pa
import pytest

from paimon_tpu.cdc import CdcSinkWriter as RefSinkWriter
from paimon_tpu.schema import SchemaChange as RefChange
from paimon_tpu_torch.cdc import CdcSinkWriter
from paimon_tpu_torch.schema import SchemaChange
from tests.test_torch_dynamic_bucket import PORT, REF, commit, rows_by_id

# (file.format, file.format.per.level): the compacted run's format over
# a level-0 file of another
MIXED = [("avro", "0:orc"), ("avro", "0:parquet"), ("csv", "0:orc")]


def _mixed_table(pkg, root, fmt, per_level, engine):
    schema = pkg.schema([("id", "BigIntType", False),
                         ("v", "IntType", True)],
                        options={"bucket": "1", "file.format": fmt,
                                 "file.format.per.level": per_level,
                                 "merge-engine": engine})
    t = pkg.create(root, schema)
    commit(t, [{"id": i, "v": i} for i in range(5)])
    t.compact(full=True)
    commit(t, [{"id": i, "v": 10 * i} for i in range(3, 8)])
    return t


@pytest.mark.parametrize("engine", ["deduplicate", "first-row"])
@pytest.mark.parametrize("fmt,per_level", MIXED,
                         ids=[f"{f}-over-{p[2:]}" for f, p in MIXED])
def test_mixed_format_levels_read_as_oracle(tmp_path, fmt, per_level,
                                            engine):
    """C.10: the port reads the rows of the two writes; the reference
    raises ArrowInvalid on the same table."""
    t = _mixed_table(PORT, str(tmp_path), fmt, per_level, engine)
    first, second = {i: i for i in range(5)}, \
        {i: 10 * i for i in range(3, 8)}
    want = {**first, **second} if engine == "deduplicate" \
        else {**second, **first}
    assert rows_by_id(t) == [{"id": k, "v": want[k]} for k in sorted(want)]
    assert t.compact(full=True) is not None
    assert rows_by_id(t) == [{"id": k, "v": want[k]} for k in sorted(want)]
    ref = _mixed_table(REF, str(tmp_path), fmt, per_level, engine)
    with pytest.raises(pa.ArrowInvalid, match="Schema at index 1"):
        ref.to_arrow()
    # the port reads the reference's files too
    assert rows_by_id(PORT.load(ref.path)) == rows_by_id(t)


def _sink_widened(pkg, root, Writer):
    t = pkg.create(root, pkg.schema([("id", "BigIntType", False)],
                                    options={"bucket": "1"}))
    sink = Writer(t)
    sink.write_events([{"op": "c", "after": {"id": 1, "x": 2 ** 60}}])
    sink.commit(1)
    sink.write_events([{"op": "c", "after": {"id": 2, "x": 0.5}}])
    sink.commit(2)
    sink.close()
    return pkg.load(t.path)


def test_sink_widened_bigint_reads_as_java_double(tmp_path):
    """C.11, the sink's input: x is BIGINT at commit 1 and widened to
    DOUBLE at commit 2; the port reads 2^60 as 1.152921504606847e18."""
    t = _sink_widened(PORT, str(tmp_path), CdcSinkWriter)
    assert rows_by_id(t) == [{"id": 1, "x": 1.152921504606847e18},
                             {"id": 2, "x": 0.5}]
    ref = _sink_widened(REF, str(tmp_path), RefSinkWriter)
    with pytest.raises(pa.ArrowInvalid, match="not in range"):
        ref.to_arrow()
    assert rows_by_id(PORT.load(ref.path)) == rows_by_id(t)


@pytest.mark.parametrize("value,want", [
    (2 ** 60, 1.152921504606847e18),
    # ties round to even, as Java's (double) long
    (2 ** 53 + 1, 9007199254740992.0), (2 ** 53 + 3, 9007199254740996.0),
    (-(2 ** 63), -9.223372036854776e18)])
def test_update_column_type_to_double_reads_as_java(tmp_path, value, want):
    """C.11, update_column_type BIGINT -> DOUBLE on a value beyond 2^53:
    the port reads Java's double; the reference raises."""
    got = {}
    for pkg, C in ((PORT, SchemaChange), (REF, RefChange)):
        t = pkg.create(str(tmp_path), pkg.schema(
            [("id", "BigIntType", False), ("x", "BigIntType", True)],
            options={"bucket": "1"}))
        commit(t, [{"id": 1, "x": value}, {"id": 2, "x": 7}])
        t.schema_manager.commit_changes(
            C.update_column_type("x", pkg.types.DoubleType()))
        got[pkg.name] = pkg.load(t.path)
    assert rows_by_id(got["port"]) == [{"id": 1, "x": want},
                                       {"id": 2, "x": 7.0}]
    with pytest.raises(pa.ArrowInvalid, match="not in range"):
        got["reference"].to_arrow()
