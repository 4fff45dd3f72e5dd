"""VARIANT of paimon_tpu_torch against paimon_tpu.

The port's data/variant.py encodes the same bytes as the reference's for
the same value (metadata dictionary and value tree), and a VARIANT
column maps to the reference's on-disk struct<metadata, value>.  The
cases of tests/test_variant.py run on both packages; seeded JSON values
are encoded by both and compared byte for byte; tables with a VARIANT
column are written by one package and read by both.
"""

import inspect
import json
import os
import re

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu.data.variant as ref_variant
import paimon_tpu_torch.data.variant as port_variant
from tests.test_torch_append import _cpu_table, reference_module
from tests.test_torch_dynamic_bucket import BOTH, PORT, REF


def _class_cases():
    path = os.path.join(os.path.dirname(__file__), "test_variant.py")
    out, cls = [], None
    with open(path) as f:
        for line in f:
            m = re.match(r"class (Test\w+)", line)
            if m:
                cls = m.group(1)
            m = re.match(r"    def (test_\w+)\(", line)
            if m and cls:
                out.append((cls, m.group(1)))
    return out


CASES = _class_cases()


def _expand(fn):
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        sets = [dict(s, **dict(zip(names, v if len(names) > 1 else (v,))))
                for s in sets for v in mark.args[1]]
    return sets


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case", CASES, ids=[f"{c}.{m}" for c, m in CASES])
def test_reference_case(tmp_path, monkeypatch, case, pkg):
    if pkg == "port":
        # the table case imports FileStoreTable inside its body
        import paimon_tpu_torch.table as port_table
        monkeypatch.setattr(port_table, "FileStoreTable",
                            _cpu_table(port_table.FileStoreTable))
    mod = reference_module("test_variant", pkg == "port")
    cls = getattr(mod, case[0])
    fn = getattr(cls, case[1])
    for i, params in enumerate(_expand(fn)):
        kwargs = dict(params)
        if "tmp_path" in inspect.signature(fn).parameters:
            kwargs["tmp_path"] = tmp_path / str(i)
            kwargs["tmp_path"].mkdir()
        getattr(cls(), case[1])(**kwargs)


# -- bytes equal to the reference's -------------------------------------------

def _random_value(rng, depth=0):
    kind = rng.integers(0, 9 if depth < 3 else 6)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-2**63, 2**63 - 1)) >> int(rng.integers(0, 63))
    if kind == 3:
        return float(rng.standard_normal())
    if kind == 4:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000,
                                                         rng.integers(0, 80)))
    if kind == 5:
        return "k" * int(rng.integers(0, 3)) + str(rng.integers(0, 1000))
    if kind in (6, 7):
        keys = [f"f{rng.integers(0, 400)}" for _ in range(rng.integers(0, 12))]
        return {k: _random_value(rng, depth + 1) for k in keys}
    return [_random_value(rng, depth + 1)
            for _ in range(rng.integers(0, 12))]


@pytest.mark.parametrize("seed", range(6))
def test_variant_bytes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        obj = {"w": int(rng.integers(1, 4096)), "h": int(rng.integers(1, 4096)),
               "tags": [_random_value(rng) for _ in range(3)],
               "extra": _random_value(rng)}
        text = json.dumps(obj)
        p, r = port_variant.Variant.from_json(text), \
            ref_variant.Variant.from_json(text)
        assert (p.metadata, p.value) == (r.metadata, r.value)
        assert p.to_object() == r.to_object() == json.loads(text)
        for path in ("$.w", "$.tags[1]", "$.extra", "$.missing.x"):
            assert port_variant.variant_get(p, path) == \
                ref_variant.variant_get(r, path)


@pytest.mark.parametrize("seed", range(3))
def test_shredding_equals_reference(seed):
    rng = np.random.default_rng(seed)
    objs = [{"a": int(rng.integers(0, 100)) if rng.random() < 0.7 else "x",
             "b": _random_value(rng)} if rng.random() < 0.9 else None
            for _ in range(200)]
    outs = []
    for mod in (port_variant, ref_variant):
        col = mod.column_from_objects(objs)
        plan = mod.ShreddingPlan({"$.a": pa.int64(), "$.b": pa.string()})
        sh = mod.shred_column(col, plan)
        outs.append((col.to_pylist(), sh.to_pylist(),
                     mod.typed_path_column(sh, plan, "$.a").to_pylist(),
                     mod.unshred_column(sh).to_pylist()))
    assert outs[0] == outs[1]


# -- tables with a VARIANT column ---------------------------------------------

def _variant_mod(pkg):
    return port_variant if pkg is PORT else ref_variant


def meta_batches(pkg, seed, commits=3, rows=150, key_range=250):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        metas = [{"w": int(rng.integers(1, 4096)),
                  "h": int(rng.integers(1, 4096)),
                  "tags": [f"t{int(t)}" for t in
                           rng.integers(0, 50, rng.integers(0, 4))]}
                 if rng.random() < 0.9 else None for _ in range(rows)]
        out.append((rng.integers(0, key_range, rows), metas))
    return [pa.table({"id": pa.array(ids, pa.int64()),
                      "meta": _variant_mod(pkg).column_from_objects(metas)})
            for ids, metas in out], out


def variant_table(pkg, root, pk=True):
    b = (pkg.Schema.builder().column("id", pkg.types.BigIntType(False))
         .column("meta", pkg.types.VariantType()))
    if pk:
        b = b.primary_key("id").options({"bucket": "1"})
    else:
        b = b.options({"bucket": "-1"})
    return pkg.create(root, b.build())


def commit(table, batch):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(batch)
    wb.new_commit().commit(w.prepare_commit())
    w.close()


def decoded(table, mod):
    out = table.to_arrow().sort_by("id")
    return list(zip(out.column("id").to_pylist(),
                    [None if v is None else v.to_object() for v in
                     mod.column_to_variants(out.column("meta"))]))


@BOTH
def test_pk_variant_table_cross_reads(tmp_path, pkg):
    batches, raw = meta_batches(pkg, 1)
    table = variant_table(pkg, str(tmp_path))
    for b in batches:
        commit(table, b)
    last = {}
    for ids, metas in raw:
        for i, m in zip(ids.tolist(), metas):
            last[i] = m
    want = sorted(last.items())
    for reader in (PORT, REF):
        assert decoded(reader.load(table.path), _variant_mod(reader)) == want
    assert table.compact(full=True) is not None
    for reader in (PORT, REF):
        t = reader.load(table.path)
        assert decoded(t, _variant_mod(reader)) == want
        ws = [None if v is None else
              _variant_mod(reader).variant_get(v, "$.w")
              for v in _variant_mod(reader).column_to_variants(
                  t.to_arrow().sort_by("id").column("meta"))]
        assert ws == [None if m is None else m["w"] for _, m in want]


@BOTH
def test_append_variant_table_cross_reads(tmp_path, pkg):
    batches, raw = meta_batches(pkg, 2)
    table = variant_table(pkg, str(tmp_path), pk=False)
    for b in batches:
        commit(table, b)
    want = sorted(((i, m) for ids, metas in raw
                   for i, m in zip(ids.tolist(), metas)),
                  key=lambda x: (x[0], json.dumps(x[1], sort_keys=True)))
    for reader in (PORT, REF):
        got = decoded(reader.load(table.path), _variant_mod(reader))
        assert sorted(got, key=lambda x: (
            x[0], json.dumps(x[1], sort_keys=True))) == want


def test_variant_arrow_type_is_the_references():
    from paimon_tpu.types import VariantType as RefVariant
    from paimon_tpu.types import data_type_to_arrow as ref_to_arrow
    from paimon_tpu_torch.types import VariantType, data_type_to_arrow
    assert data_type_to_arrow(VariantType()) == \
        ref_to_arrow(RefVariant()) == port_variant.variant_arrow_type()
