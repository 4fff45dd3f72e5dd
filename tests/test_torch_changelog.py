"""paimon_tpu_torch's changelog producers against paimon_tpu's.

The cases of tests/test_changelog_producers.py (all but the point-lookup
case, which needs the lookup store), lookup under partial-update and
aggregation, seeded multi-commit tables whose changelog files must equal
the reference's row for row and in order, and a cross-read: what either
package writes, either package stream-reads the same.  Both packages run
on the CPU (the port with device="cpu").  Every value compared is a
table row, so equality is exact.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import IntType as RefInt
from paimon_tpu_torch.core.read import ROW_KIND_COL
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, IntType, RowKind

PRODUCERS = ["input", "lookup", "full-compaction"]


class Package:
    """One package's table API, so a scenario runs unchanged on both."""

    def __init__(self, name, schema, table, types, kwargs):
        self.name = name
        self.Table = table
        self._schema = schema
        self._big, self._dbl, self._int = types
        self.kwargs = kwargs

    def table(self, root, opts, columns=("v",), name="t"):
        b = self._schema.builder().column("id", self._big(False))
        for c in columns:
            b = b.column(c, self._dbl() if c == "v" else self._int())
        options = {"bucket": "1", "write-only": "true"}
        options.update(opts)
        return self.Table.create(
            os.path.join(root, self.name, name),
            b.primary_key("id").options(options).build(), **self.kwargs)

    def load(self, path, opts=None):
        return self.Table.load(path, dynamic_options=opts, **self.kwargs)


PORT = Package("port", Schema, FileStoreTable,
               (BigIntType, DoubleType, IntType), {"device": "cpu"})
REF = Package("reference", RefSchema, RefTable,
              (RefBigInt, RefDouble, RefInt), {})


def rows_of(t: pa.Table):
    """A table's rows, a NaN spelled "NaN" so that equal rows compare
    equal."""
    return [{k: ("NaN" if isinstance(v, float) and v != v else v)
             for k, v in r.items()} for r in t.to_pylist()]


def commit(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows, row_kinds=kinds)
    sid = wb.new_commit().commit(w.prepare_commit())
    w.close()
    return sid


def drain(table, scan):
    rows = []
    while True:
        p = scan.plan()
        if p is None:
            return rows
        rows.extend(rows_of(table.new_read_builder().new_read()
                            .to_arrow(p)))


def latest_scan(table):
    scan = table.copy({"scan.mode": "latest"}) \
        .new_read_builder().new_stream_scan()
    scan.plan()
    return scan


def changelog_files(table_path):
    """{snapshot id: the rows of its changelog files, file by file in
    manifest order, every KV column}, read with pyarrow alone."""
    port = FileStoreTable.load(table_path, device="cpu")
    scan = port.new_scan()
    out = {}
    for snap in port.snapshot_manager.snapshots():
        tables = [pq.read_table(scan.path_factory.data_file_path(
                      s.partition, s.bucket, f.file_name))
                  for s in scan.plan_changelog(snap).splits
                  for f in s.data_files]
        if tables:
            out[snap.id] = rows_of(pa.concat_tables(tables))
    return out


def both(scenario, tmp_path):
    got = scenario(PORT, str(tmp_path))
    want = scenario(REF, str(tmp_path))
    assert got == want
    return got


# -- the reference's cases ---------------------------------------------------

@pytest.mark.parametrize("producer", ["full-compaction", "lookup"])
def test_compaction_changelog_insert_update_delete(tmp_path, producer):
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": producer})
        commit(table, [{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}])
        table.compact(full=True)
        scan = latest_scan(table)
        # upsert 1, insert 3, delete 2 -> compact -> changelog
        commit(table, [{"id": 1, "v": 10.0}, {"id": 3, "v": 3.0}])
        commit(table, [{"id": 2, "v": 0.0}], kinds=[RowKind.DELETE])
        table.compact(full=True)
        return drain(table, scan)

    rows = both(run, tmp_path)
    by_kind = {}
    for r in rows:
        by_kind.setdefault(r[ROW_KIND_COL], []).append(r)
    assert [r["id"] for r in by_kind.get(RowKind.INSERT, [])] == [3]
    assert [r["id"] for r in by_kind.get(RowKind.DELETE, [])] == [2]
    assert [(r["id"], r["v"]) for r in
            by_kind.get(RowKind.UPDATE_BEFORE, [])] == [(1, 1.0)]
    assert [(r["id"], r["v"]) for r in
            by_kind.get(RowKind.UPDATE_AFTER, [])] == [(1, 10.0)]
    # -U comes immediately before its +U in the emitted order
    kinds_seq = [r[ROW_KIND_COL] for r in rows]
    i = kinds_seq.index(RowKind.UPDATE_BEFORE)
    assert kinds_seq[i + 1] == RowKind.UPDATE_AFTER


def test_full_compaction_no_change_no_changelog(tmp_path):
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": "full-compaction"})
        commit(table, [{"id": 1, "v": 1.0}])
        table.compact(full=True)
        scan = latest_scan(table)
        # full compaction with no new data -> no changelog rows
        table.compact(full=True)
        return drain(table, scan)

    assert both(run, tmp_path) == []


def test_lookup_producer_emits_old_values_from_higher_levels(tmp_path):
    """The compaction unit only contains L0; the old value lives in a
    higher level and must be looked up."""
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": "lookup"})
        commit(table, [{"id": 7, "v": 1.0}])
        table.compact(full=True)               # id=7 now at max level
        scan = latest_scan(table)
        commit(table, [{"id": 7, "v": 2.0}])   # L0 only
        table.compact(full=True)
        return drain(table, scan)

    rows = both(run, tmp_path)
    assert [(r["id"], r["v"], r[ROW_KIND_COL]) for r in rows] == \
        [(7, 1.0, RowKind.UPDATE_BEFORE), (7, 2.0, RowKind.UPDATE_AFTER)]


def test_full_compaction_first_data_emits_inserts(tmp_path):
    """A single-file upgrade into the top level must still produce +I
    changelog (no silent metadata-only promotion)."""
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": "full-compaction"})
        scan = latest_scan(table)
        commit(table, [{"id": 1, "v": 1.0}])   # ONE L0 file
        table.compact(full=True)
        return drain(table, scan)

    rows = both(run, tmp_path)
    assert [(r["id"], r[ROW_KIND_COL]) for r in rows] == \
        [(1, RowKind.INSERT)]


def test_lookup_blocks_l0_promotion(tmp_path):
    """A lone L0 file is rewritten, never promoted, under lookup: its keys
    have not been changelogged yet."""
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": "lookup"})
        commit(table, [{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}])
        before = {f.file_name for s in table.new_scan().plan().splits
                  for f in s.data_files}
        table.compact(full=True)
        after = {f.file_name for s in table.new_scan().plan().splits
                 for f in s.data_files}
        snap = table.snapshot_manager.latest_snapshot()
        return (bool(before & after), snap.changelog_record_count)

    assert both(run, tmp_path) == (False, 2)


# -- seeded multi-commit tables: changelog files row for row ----------------

def seeded_commits(seed, keys=300, commits=8, rows=200):
    """(rows, kinds) per commit: uniform ids, 1 row in 20 a DELETE."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        ids = rng.integers(0, keys, rows)
        vals = rng.choice([0.25, 0.5, 1.0, np.nan], rows)
        kinds = np.where(rng.random(rows) < 0.05, RowKind.DELETE,
                         RowKind.INSERT).astype(np.int8)
        out.append(([{"id": int(i), "v": float(v)}
                     for i, v in zip(ids, vals)], kinds.tolist()))
    return out


def stream_write(table, batches, full_every=0):
    """One streaming commit per batch (identifiers 1..), inline
    compaction on; a full compaction after every `full_every` commits."""
    wb = table.new_stream_write_builder().with_commit_user("job")
    for k, (rows, kinds) in enumerate(batches, start=1):
        with wb.new_write() as w:
            w.write_dicts(rows, row_kinds=kinds)
            wb.new_commit().commit(w.prepare_commit(), commit_identifier=k)
        if full_every and k % full_every == 0:
            table.compact(full=True)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("producer", PRODUCERS)
def test_changelog_files_equal_reference(tmp_path, producer, seed):
    def run(pkg, root):
        table = pkg.table(root, {"changelog-producer": producer,
                                 "write-only": "false"})
        stream_write(table, seeded_commits(seed), full_every=3)
        return changelog_files(table.path), \
            rows_of(table.to_arrow().sort_by("id"))

    files, final = both(run, str(tmp_path))
    assert files, "no changelog was produced"
    rows = [r for s in sorted(files) for r in files[s]]
    assert {r["_VALUE_KIND"] for r in rows} <= {0, 1, 2, 3}
    assert final


@pytest.mark.parametrize("engine", ["partial-update", "aggregation"])
def test_lookup_replay_merges_by_engine(tmp_path, engine):
    """The lookup producer's evolving state folds each L0 file under the
    table's engine, not last-writer-wins: the changelog carries the
    folded values."""
    opts = {"changelog-producer": "lookup", "write-only": "false",
            "merge-engine": engine}
    if engine == "aggregation":
        opts.update({"fields.a.aggregate-function": "sum",
                     "fields.b.aggregate-function": "max"})

    def run(pkg, root):
        table = pkg.table(root, opts, columns=("a", "b"))
        rng = np.random.default_rng(4)
        batches = []
        for _ in range(7):
            ids = rng.integers(0, 60, 80)
            a = rng.integers(0, 10, 80)
            b = rng.integers(0, 10, 80)
            nulls = rng.random(80) < 0.3
            batches.append(([{"id": int(i), "a": int(x),
                              "b": None if n else int(y)}
                             for i, x, y, n in zip(ids, a, b, nulls)],
                            None))
        stream_write(table, batches, full_every=4)
        # changelog every L0 file still pending
        table.compact(full=True)
        return changelog_files(table.path), \
            table.to_arrow().sort_by("id").to_pylist()

    files, final = both(run, str(tmp_path))
    assert files
    # the stream folded to its end equals the batch read
    state = {}
    for s in sorted(files):
        for r in files[s]:
            if r["_VALUE_KIND"] in (RowKind.INSERT, RowKind.UPDATE_AFTER):
                state[r["id"]] = {"id": r["id"], "a": r["a"], "b": r["b"]}
            else:
                state.pop(r["id"], None)
    assert [state[k] for k in sorted(state)] == final


# -- cross-read -------------------------------------------------------------

@pytest.mark.parametrize("producer", PRODUCERS)
def test_each_package_stream_reads_the_other(tmp_path, producer):
    """A table written by either package, stream-read from its first
    snapshot by either package, gives the same changelog rows."""
    reads = {}
    for writer in (PORT, REF):
        table = writer.table(str(tmp_path), {"changelog-producer": producer,
                                             "write-only": "false"})
        stream_write(table, seeded_commits(11, commits=6), full_every=2)
        for reader in (PORT, REF):
            t = reader.load(table.path, {"scan.mode": "from-snapshot",
                                         "scan.snapshot-id": "1"})
            scan = t.new_read_builder().new_stream_scan()
            reads[(writer.name, reader.name)] = drain(t, scan)
    first = reads[("port", "port")]
    assert first
    assert all(r == first for r in reads.values())
