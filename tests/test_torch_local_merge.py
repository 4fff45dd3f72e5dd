"""paimon_tpu_torch's LocalMerger against paimon_tpu.

The six cases of tests/test_local_merge.py, each run on both packages
and compared: rows buffer before bucket routing and fold to their
winning version once `local-merge-buffer-size` is reached (a device
merge; here the kernel's plain version on device="cpu"), so a hot key
reaches the bucket writers once a fold.  Every comparison is exact.
"""

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_dynamic_bucket import PORT, REF

ID_V = [("id", "BigIntType", False), ("v", "DoubleType", True)]


def lm_table(pkg, root, cols=ID_V, pk=("id",), partitions=(), **opts):
    options = {"bucket": "2", "write-only": "true",
               "local-merge-buffer-size": "1mb", **opts}
    return pkg.create(str(root), pkg.schema(cols, pk=pk,
                                            partitions=partitions,
                                            options=options))


def both(scenario, tmp_path):
    """Run `scenario(pkg, root)` on each package; their results must be
    equal.  Returns the port's."""
    got = [scenario(pkg, tmp_path / pkg.name) for pkg in (PORT, REF)]
    assert got[0] == got[1]
    return got[0]


def stored_rows(t):
    """Rows stored in the table's data files (after the folds)."""
    return sum(f.row_count
               for s in t.new_read_builder().new_scan().plan().splits
               for f in s.data_files)


def test_hot_key_collapses_before_bucket_write(tmp_path):
    def scenario(pkg, root):
        t = lm_table(pkg, root)
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        # 100 updates of one hot key and cold keys, many small writes
        for i in range(100):
            w.write_dicts([{"id": 7, "v": float(i)},
                           {"id": 1000 + i, "v": 1.0}])
        wb.new_commit().commit(w.prepare_commit())
        w.close()
        return t.to_arrow().sort_by("id").to_pylist(), stored_rows(t)

    out, stored = both(scenario, tmp_path)
    assert [r for r in out if r["id"] == 7][0]["v"] == 99.0
    assert len(out) == 101 and stored == 101


def test_delete_wins_through_local_merge(tmp_path):
    def scenario(pkg, root):
        t = lm_table(pkg, root)
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write_dicts([{"id": 1, "v": 1.0}, {"id": 2, "v": 2.0}])
        w.write_dicts([{"id": 1, "v": 1.0}], row_kinds=[3])   # -D
        wb.new_commit().commit(w.prepare_commit())
        w.close()
        return [r["id"] for r in t.to_arrow().to_pylist()]

    assert both(scenario, tmp_path) == [2]


def test_sequence_field_respected(tmp_path):
    def scenario(pkg, root):
        t = lm_table(pkg, root, **{"sequence.field": "v"})
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write_dicts([{"id": 1, "v": 9.0}])
        w.write_dicts([{"id": 1, "v": 3.0}])     # lower sequence: loses
        wb.new_commit().commit(w.prepare_commit())
        w.close()
        return t.to_arrow().to_pylist()

    assert both(scenario, tmp_path)[0]["v"] == 9.0


def test_buffer_flush_at_threshold(tmp_path):
    """A 4 KB buffer folds many times within one commit; each fold's
    winners reach the bucket writer, whose flush merges the folds."""
    def scenario(pkg, root):
        t = lm_table(pkg, root, **{"bucket": "1",
                                   "local-merge-buffer-size": "4kb"})
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        rng = np.random.default_rng(5)
        for i in range(50):
            ids = rng.integers(0, 64, 64)
            w.write_arrow(pa.table({
                "id": pa.array(ids, pa.int64()),
                "v": pa.array(np.full(64, float(i)))}))
        msgs = w.prepare_commit()
        files = [(f.row_count, f.min_key, f.max_key)
                 for m in msgs for f in m.new_files]
        wb.new_commit().commit(msgs)
        w.close()
        return t.to_arrow().sort_by("id").to_pylist(), files

    rows, files = both(scenario, tmp_path)
    assert len(rows) == len({r["id"] for r in rows}) <= 64
    assert files


def test_partitioned_rows_do_not_collapse(tmp_path):
    """The fold key includes the partition columns: one id in two
    partitions stays two rows (pk = (pt, id))."""
    cols = [("pt", "IntType", False), ("id", "BigIntType", False),
            ("v", "DoubleType", True)]

    def scenario(pkg, root):
        t = lm_table(pkg, root, cols=cols, pk=("pt", "id"),
                     partitions=("pt",), bucket="1")
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write_dicts([{"pt": 1, "id": 1, "v": 1.0},
                       {"pt": 2, "id": 1, "v": 2.0}])
        wb.new_commit().commit(w.prepare_commit())
        w.close()
        rows = sorted(t.to_arrow().to_pylist(), key=lambda r: r["pt"])
        return [(r["pt"], r["v"]) for r in rows]

    assert both(scenario, tmp_path) == [(1, 1.0), (2, 2.0)]


@pytest.mark.parametrize("opts, match", [
    ({"merge-engine": "partial-update"}, "local-merge"),
    ({"merge-engine": "aggregation"}, "local-merge"),
    ({"changelog-producer": "input"}, "changelog")])
def test_incompatible_configs_refuse(tmp_path, opts, match):
    """Only deduplicate and first-row fold, and input changelog is
    refused: both packages raise the same ValueError at new_write."""
    for pkg in (PORT, REF):
        t = lm_table(pkg, tmp_path / pkg.name, **opts)
        with pytest.raises(ValueError, match=match):
            t.new_batch_write_builder().new_write()


def test_first_row_and_skewed_stream_match_reference(tmp_path):
    """Half of each commit on 50 hot ids, half uniform: under first-row
    and deduplicate every commit's L0 rows are the commit's distinct
    ids, equal to the reference's."""
    def scenario(pkg, root, engine):
        t = lm_table(pkg, root, **{"merge-engine": engine})
        rng = np.random.default_rng(11)
        out = []
        for _ in range(3):
            ids = np.concatenate([rng.integers(0, 50, 500),
                                  rng.integers(0, 5000, 500)])
            rng.shuffle(ids)
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            w.write_arrow(pa.table({
                "id": pa.array(ids, pa.int64()),
                "v": pa.array(rng.random(ids.size))}))
            msgs = w.prepare_commit()
            out.append(sum(f.row_count for m in msgs
                           for f in m.new_files) == len(np.unique(ids)))
            wb.new_commit().commit(msgs)
            w.close()
        return out, t.to_arrow().sort_by("id").to_pylist()

    for engine in ("deduplicate", "first-row"):
        got = [scenario(pkg, tmp_path / engine / pkg.name, engine)
               for pkg in (PORT, REF)]
        assert got[0] == got[1]
        assert got[0][0] == [True, True, True]
