"""The object-store FileIO, the in-memory FileIO and the scheme registry
of paimon_tpu_torch against paimon_tpu.

The 13 cases of tests/test_object_store.py (conditional PUT as the
commit CAS, listings that synthesize directories and never show
staging, the two-phase stream, ranged and vectored reads, the rename
contract, a table's whole lifecycle on the bucket, 503 storms,
ambiguous PUTs and lagging LISTs) and the cases of tests/test_fs.py
(MemoryFileIO beside the local FileIO, the scheme registry) run on both
packages (tests/test_torch_append.py `reference_module`).  A table
written through one package's ObjectStoreFileIO over a
LocalObjectStoreBackend root is read by the other package over its own
backend on the same root, both ways: equal rows and equal object keys.
"""

import numpy as np
import pyarrow as pa
import pytest

import paimon_tpu as ref
from paimon_tpu.fs import object_store as ref_os
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch import Schema
from paimon_tpu_torch.fs import get_file_io, object_store, register_file_io
from paimon_tpu_torch.fs.fileio import _REGISTRY
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType
from tests.test_torch_append import reference_cases, run_reference_case
from tests.test_torch_vector import WithParams, case_ids

# parametrized reference cases: (parameter, values)
PARAMS = {
    "TestFaultInjection.test_lifecycle_survives_storms": (
        "seed", (11, 23, 47)),
    "test_commit_deadline_abort_cleans_manifests": (
        "slow_shape", ("all-ops", "puts-only")),
    "test_service_deadline_504": ("via", ("body", "option")),
}
# test_fs.py's `fio` fixture reads request.param
FIO_PARAM = ("local", "mem")


class _Param:
    """The `request` a parametrized module fixture reads."""

    def __init__(self, param):
        self.param = param

    def __str__(self):
        return str(self.param)


def expand(name, skip=(), fio_params=False):
    """(case, parameters) of each case of reference test file `name`,
    one per parameter value."""
    import ast
    import os
    with open(os.path.join(os.path.dirname(__file__), f"{name}.py")) as f:
        tree = ast.parse(f.read())
    uses_fio = {n.name for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef)
                and any(a.arg == "fio" for a in n.args.args)}
    out = []
    for case in reference_cases(name, skip=skip, classes=True):
        short = case[1].rpartition(".")[2]
        if case[1] in PARAMS:
            p, values = PARAMS[case[1]]
            out += [(case, {p: v}) for v in values]
        elif fio_params and short in uses_fio:
            out += [(case, {"request": _Param(v)}) for v in FIO_PARAM]
        else:
            out.append((case, {}))
    return out


def run_case(case, params, pkg, tmp_path, monkeypatch, request):
    run_reference_case(case, pkg, tmp_path, monkeypatch,
                       WithParams(request, params))


# -- the process-wide state of both packages ------------------------------------

def _process_state(pkg):
    """What a test of the serving plane can leave behind in `pkg`'s
    process: the scheme registry, the degraded switch's sources, the
    live resilient backends (the breaker states that /healthz and the
    brownout read), the resilient wrapper shared by each store,
    tracing, the disk tiers (with the one the shared byte cache
    holds), the delta tiers and the plan caches."""
    import importlib
    m = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "fs.fileio", "fs.resilience", "fs.caching", "service.delta",
        "core.plan_cache", "obs.trace")}
    res, caching = m["fs.resilience"], m["fs.caching"]
    shared = res._SHARED_RESILIENT
    return {
        "schemes": dict(m["fs.fileio"]._REGISTRY),
        "degraded": (res.is_degraded(), frozenset(res._DEGRADED_SOURCES)),
        "backends": frozenset(id(b) for b in (r() for r in res._BACKENDS)
                              if b is not None),
        "shared resilient": frozenset(
            id(w) for w in (r() for r in (shared or {}).values())
            if w is not None),
        "tracing": m["obs.trace"].tracing_enabled(),
        "disk tiers": dict(caching._DISK_TIERS),
        "shared disk tier": caching._SHARED_STATE is not None and
        caching._SHARED_STATE.disk is not None,
        "delta tiers": dict(m["service.delta"]._TIERS),
        "plan caches": len(m["core.plan_cache"]._CACHES),
    }


def _reset_process_state(pkg, to=None):
    """Reset `pkg`'s disk tiers, delta tiers and plan caches; with `to`
    (a _process_state), put back its scheme registry, degraded switch
    and tracing, and close and forget the resilient backends made
    since."""
    import importlib
    for name, fn in (("fs.caching", "reset_disk_tiers"),
                     ("service.delta", "reset_delta_tiers"),
                     ("core.plan_cache", "reset_plan_caches")):
        getattr(importlib.import_module(f"{pkg}.{name}"), fn)()
    if to is None:
        return
    fileio = importlib.import_module(f"{pkg}.fs.fileio")
    res = importlib.import_module(f"{pkg}.fs.resilience")
    trace = importlib.import_module(f"{pkg}.obs.trace")
    fileio._REGISTRY.clear()
    fileio._REGISTRY.update(to["schemes"])
    sources = set(res._DEGRADED_SOURCES)
    for s in sources - to["degraded"][1]:
        res.set_degraded_for(s, False)
    for s in to["degraded"][1] - sources:
        res.set_degraded_for(s, True)
    with res._BACKENDS_LOCK:
        keep = [r for r in res._BACKENDS if id(r()) in to["backends"]]
        made = [r() for r in res._BACKENDS if r() is not None
                and id(r()) not in to["backends"]]
        res._BACKENDS[:] = keep
    with res._SHARED_LOCK:
        shared = res._SHARED_RESILIENT or {}
        for store in [s for s, r in list(shared.items())
                      if id(r()) not in to["shared resilient"]]:
            del shared[store]
    for b in made:
        b.close()
    if not to["tracing"]:
        trace.disable_tracing()


@pytest.fixture
def clean_process_state():
    """Each test leaves both packages' process-wide state as it found
    it: reset before the test, put back after it, then checked, so that
    no later test in the worker inherits a scheme, an open breaker, a
    brownout, tracing, or a disk tier over another test's directory."""
    pkgs = ("paimon_tpu", "paimon_tpu_torch")
    for pkg in pkgs:
        _reset_process_state(pkg)
    before = {pkg: _process_state(pkg) for pkg in pkgs}
    yield
    for pkg in pkgs:
        _reset_process_state(pkg, before[pkg])
    assert {pkg: _process_state(pkg) for pkg in pkgs} == before


pytestmark = pytest.mark.usefixtures("clean_process_state")
CASES = expand("test_object_store") + expand("test_fs", fio_params=True)


def test_reference_cases_are_all_listed():
    assert len(reference_cases("test_object_store", classes=True)) == 13
    # the storm case runs at 3 seeds; test_fs.py's `fio` cases on both
    # of its FileIOs
    assert len(CASES) == 15 + 5 * 2 + 5


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- the scheme registry -------------------------------------------------------

def test_registered_scheme_resolves_and_unknown_raises(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr("paimon_tpu_torch.fs.fileio._REGISTRY",
                        dict(_REGISTRY))
    store = object_store.ObjectStoreFileIO(
        object_store.LocalObjectStoreBackend(str(tmp_path / "b")),
        scheme="unit://")
    register_file_io("unit", lambda: store)
    assert get_file_io("unit://t/x") is store
    assert isinstance(get_file_io(f"file://{tmp_path}"),
                      type(get_file_io(str(tmp_path))))
    with pytest.raises(ValueError, match="No FileIO registered"):
        get_file_io("s3://bucket/t")
    with pytest.raises(ValueError, match="No FileIO registered"):
        ref.fs.get_file_io("s3://bucket/t")


# -- cross-reads over one bucket -------------------------------------------------

def _rows(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, n)
    return pa.table({"id": pa.array(ids, pa.int64()),
                     "v": pa.array(rng.random(n), pa.float64()),
                     "name": pa.array([f"n{i % 97}" for i in ids])})


def _write(table, batches):
    for b in batches:
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(b)
            wb.new_commit().commit(w.prepare_commit())


def _port_table(fio, path, create):
    if create:
        schema = (Schema.builder().column("id", BigIntType(False))
                  .column("v", DoubleType())
                  .column("name", VarCharType.string_type())
                  .primary_key("id").options({"bucket": "2"}).build())
        return FileStoreTable.create(path, schema, file_io=fio,
                                     device="cpu")
    return FileStoreTable.load(path, file_io=fio, device="cpu")


def _ref_table(fio, path, create):
    if create:
        schema = (ref.Schema.builder().column("id", RefBigInt(False))
                  .column("v", RefDouble())
                  .column("name", RefVarChar.string_type())
                  .primary_key("id").options({"bucket": "2"}).build())
        return RefTable.create(path, schema, file_io=fio)
    return RefTable.load(path, file_io=fio)


def _sorted(t):
    return t.sort_by("id").to_pylist()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_table_cross_read_over_one_bucket(tmp_path, writer):
    root = str(tmp_path / "bucket")
    port_fio = object_store.ObjectStoreFileIO(
        object_store.LocalObjectStoreBackend(root))
    ref_fio = ref_os.ObjectStoreFileIO(ref_os.LocalObjectStoreBackend(root))
    path = "objfs://wh/db/t"
    batches = [_rows(400, s) for s in range(3)]
    if writer == "reference":
        w = _ref_table(ref_fio, path, True)
        _write(w, batches)
        w.compact(full=True)
        _write(w, [_rows(100, 9)])
        written = _sorted(w.to_arrow())
        r = _port_table(port_fio, path, False)
    else:
        w = _port_table(port_fio, path, True)
        _write(w, batches)
        w.compact(full=True)
        _write(w, [_rows(100, 9)])
        written = _sorted(w.to_arrow())
        r = _ref_table(ref_fio, path, False)
    assert _sorted(r.to_arrow()) == written
    assert r.latest_snapshot().id == w.latest_snapshot().id
    # the two packages see the same object keys in the bucket
    keys = [k for k, _ in object_store.LocalObjectStoreBackend(root)
            .list("wh/")]
    assert keys == [k for k, _ in ref_os.LocalObjectStoreBackend(root)
                    .list("wh/")]
    assert any(k.startswith("wh/db/t/snapshot/") for k in keys)
    # the reader then writes on: the writer reads its commit back
    _write(r, [_rows(50, 10)])
    w2 = (_ref_table(ref_fio, path, False) if writer == "reference"
          else _port_table(port_fio, path, False))
    assert _sorted(w2.to_arrow()) == _sorted(r.to_arrow())
