"""The VFS of paimon_tpu_torch against paimon_tpu.

The 4 cases of tests/test_vfs_object.py (the object table, browsing a
filesystem catalog's warehouse, path traversal refused, browsing
through the REST catalog) run on both packages
(tests/test_torch_object_store.py `run_case`).  Each package's VFS
lists a table written by the other the same way and opens its files
byte for byte.
"""

import os

import pytest

from tests.test_torch_object_store import expand, run_case
from tests.test_torch_vector import case_ids

CASES = expand("test_vfs_object")


def test_reference_cases_are_all_listed():
    assert len(CASES) == 4


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_vfs_views_agree_across_packages(tmp_path, writer):
    import paimon_tpu
    import paimon_tpu_torch
    from paimon_tpu.schema import Schema as RefSchema
    from paimon_tpu.types import BigIntType as RefBigInt
    from paimon_tpu.vfs import Vfs as RefVfs
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import BigIntType
    from paimon_tpu_torch.vfs import Vfs

    wh = str(tmp_path / "wh")
    cats = {"port": paimon_tpu_torch.create_catalog({"warehouse": wh},
                                                    device="cpu"),
            "reference": paimon_tpu.create_catalog({"warehouse": wh})}
    S, B = (Schema, BigIntType) if writer == "port" else \
        (RefSchema, RefBigInt)
    cat = cats[writer]
    cat.create_database("db")
    t = cat.create_table("db.t", S.builder().column("id", B(False))
                         .primary_key("id").options({"bucket": "2"})
                         .build())
    for k in range(2):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write_dicts([{"id": i} for i in range(k * 10, k * 10 + 10)])
        wb.new_commit().commit(w.prepare_commit())
        w.close()
    views = {"port": Vfs(cats["port"]), "reference": RefVfs(cats["reference"])}

    def walk(vfs, path="/"):
        out = {}
        for st in vfs.listdir(path):
            out[st.path] = (st.size, st.is_dir)
            if st.is_dir:
                out.update(walk(vfs, st.path))
        return out

    trees = {k: walk(v) for k, v in views.items()}
    assert trees["port"] == trees["reference"]
    files = [p for p, (_, d) in trees["port"].items() if not d]
    assert "/db/t/snapshot/snapshot-2" in files
    for p in files:
        on_disk = open(os.path.join(wh, "db.db", *p.split("/")[2:]),
                       "rb").read() if os.path.isdir(
            os.path.join(wh, "db.db")) else None
        got = views["port"].open(p)
        assert got == views["reference"].open(p)
        if on_disk is not None:
            assert got == on_disk
        assert views["port"].size(p) == len(got)
