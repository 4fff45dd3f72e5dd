"""The Iceberg export of paimon_tpu_torch against paimon_tpu.

The 4 cases of tests/test_iceberg.py (the export's metadata chain, the
reader's round trip of an append table and of a primary-key table's
read-optimized view, the reader's refusals) and the 9 of
tests/test_iceberg_rest.py (the REST committer's create, CAS commit,
conflict and recreate paths, DLF signing against the loopback REST
server) run on both packages (tests/test_torch_object_store.py
`run_case`).

Cross-read: one table directory, written by either package, is copied
and exported by each package once.  Each package's `IcebergTable` reads
both exports row for row as the table reads; the two exports' metadata
JSON are equal apart from uuids and paths, and their avro manifests
record for record apart from the paths.
"""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu.format import avro as ref_avro
from paimon_tpu.iceberg.reader import IcebergTable as RefIcebergTable
from paimon_tpu_torch.format import avro
from paimon_tpu_torch.iceberg.reader import IcebergTable
from tests.test_torch_dynamic_bucket import PORT, REF, commit_arrow
from tests.test_torch_object_store import expand, run_case
from tests.test_torch_vector import case_ids

CASES = expand("test_iceberg") + expand("test_iceberg_rest")


def test_reference_cases_are_all_listed():
    assert len(expand("test_iceberg")) == 4
    assert len(expand("test_iceberg_rest")) == 9


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- one table, exported by each package --------------------------------------

COLUMNS = [("id", "BigIntType", False), ("dt", "VarCharType", False),
           ("v", "DoubleType", True), ("n", "IntType", True)]
# (primary key, partitions, options) of each table kind
KINDS = {
    "append": ((), (), {"bucket": "-1"}),
    "append_partitioned": ((), ("dt",), {"bucket": "2",
                                         "bucket-key": "id"}),
    "pk_partitioned": (("id", "dt"), ("dt",), {"bucket": "2",
                                               "write-only": "true"}),
    "pk_orc_top_level": (("id",), (), {"bucket": "1", "write-only": "true",
                                       "file.format.per.level": "5:orc"}),
}


def _batch(rng, n):
    return pa.table({
        "id": pa.array(rng.integers(0, 400, n), pa.int64()),
        "dt": pa.array(np.array(["d1", "d2", "d3"])[rng.integers(0, 3, n)]),
        "v": pa.array(rng.random(n)),
        "n": pa.array(rng.integers(0, 9, n).astype(np.int32),
                      mask=rng.random(n) < 0.1)})


def _written(pkg, root, kind):
    """A table of `kind` written by `pkg`: 3 commits from seed 5, a full
    compaction, then (primary-key kinds) a commit only a merge-on-read
    scan sees.  -> (the table, the rows an Iceberg reader must see:
    every row of an append table, a primary-key table's rows as of its
    compaction)."""
    pk, parts, options = KINDS[kind]
    schema = pkg.schema(COLUMNS, pk=pk, partitions=parts, options=options)
    t = pkg.create(root, schema)
    rng = np.random.default_rng(5)
    for _ in range(3):
        commit_arrow(t, _batch(rng, 300))
    t.compact(full=True)
    view = t.to_arrow()
    if pk:
        commit_arrow(t, _batch(rng, 50))
    return t, view


def _by_id(t):
    return t.sort_by([("id", "ascending"), ("dt", "ascending"),
                      ("v", "ascending")])


def _unpathed(meta, root):
    """The metadata JSON with its uuids and `root` taken out."""
    text = json.dumps(meta, sort_keys=True).replace(root, "<root>")
    out = json.loads(text)
    out.pop("table-uuid")
    for snap in out["snapshots"]:
        snap["manifest-list"] = snap["manifest-list"].split("/snap-")[0]
    return out


def _manifests(meta, root):
    """The manifest list's records and each manifest's, paths made
    relative to `root`."""
    _, mlist = avro.read_container(
        open(meta["snapshots"][0]["manifest-list"], "rb").read())
    entries = []
    for m in mlist:
        _, es = avro.read_container(open(m["manifest_path"], "rb").read())
        entries += es
    for m in mlist:
        m["manifest_path"] = "<manifest>"
        m["manifest_length"] = None     # its paths are in its bytes
    for e in entries:
        e["data_file"]["file_path"] = os.path.relpath(
            e["data_file"]["file_path"], root)
    return mlist, sorted(entries, key=lambda e: e["data_file"]["file_path"])


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer", [PORT, REF], ids=["port", "ref"])
def test_exports_cross_read_and_match(tmp_path, writer, kind):
    t, view = _written(writer, str(tmp_path), kind)
    roots = {"port": str(tmp_path / "port_export"),
             "ref": str(tmp_path / "ref_export")}
    metas = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        shutil.copytree(t.path, roots[name])
        table = pkg.Table.load(roots[name], **pkg.kwargs)
        metas[name] = json.loads(open(table.sync_iceberg()).read())
    want = _by_id(view.select(["id", "dt", "v", "n"]))
    for name, root in roots.items():
        for reader in (IcebergTable, RefIcebergTable):
            got = reader.load(root).to_arrow()
            assert _by_id(got).equals(want), (name, reader.__module__)
    assert _unpathed(metas["port"], roots["port"]) == \
        _unpathed(metas["ref"], roots["ref"])
    assert _manifests(metas["port"], roots["port"]) == \
        _manifests(metas["ref"], roots["ref"])


def test_avro_manifest_bytes_equal_with_fixed_sync_marker(tmp_path,
                                                          monkeypatch):
    """With the avro sync marker fixed in both packages, the two
    exports' manifests of one table are byte-equal once the table roots
    have the same length."""
    import functools
    from paimon_tpu.iceberg import metadata as ref_meta
    from paimon_tpu_torch.iceberg import metadata
    marker = bytes(range(16))
    for mod, codec in ((metadata, avro), (ref_meta, ref_avro)):
        monkeypatch.setattr(mod.avro_fmt, "write_container",
                            functools.partial(codec.write_container,
                                              sync_marker=marker))
    t, _ = _written(REF, str(tmp_path), "append_partitioned")
    out = {}
    for name, pkg in (("aaaa", PORT), ("bbbb", REF)):
        root = str(tmp_path / name)
        shutil.copytree(t.path, root)
        meta = json.loads(open(pkg.Table.load(
            root, **pkg.kwargs).sync_iceberg()).read())
        _, mlist = avro.read_container(
            open(meta["snapshots"][0]["manifest-list"], "rb").read())
        body = open(mlist[0]["manifest_path"], "rb").read()
        out[name] = body.replace(root.encode(), b"<root>")
    assert out["aaaa"] == out["bbbb"]
