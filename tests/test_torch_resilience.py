"""Tail tolerance of paimon_tpu_torch against paimon_tpu: request
deadlines on the table's reads and commits, hedged reads, circuit
breakers and the latency model of fs/resilience.py.

The cases of tests/test_resilience.py run on both packages (see
tests/test_torch_object_store.py `run_case`), the breaker and hedge
state machines on the reference's virtual clocks, except those that
tests/test_torch_serving.py already holds (admission, brownout and the
service's 504 / 400 deadlines).  A scan through a hedged, breaker-
guarded table over a store with a heavy GET tail returns the rows the
plain table returns, in both packages, and the two packages' rows are
equal.  A commit inside a span stamps its context into the snapshot's
`trace.context` property in both packages.
"""

import numpy as np
import pyarrow as pa
import pytest

from tests.test_torch_object_store import (  # noqa: F401 -- a fixture
    clean_process_state, expand, run_case,
)
from tests.test_torch_vector import case_ids

pytestmark = pytest.mark.usefixtures("clean_process_state")

SKIP = (
    # held in tests/test_torch_serving.py
    "test_admission_deadline_bounds_queue_wait",
    "test_admission_brownout_shed_by_priority",
    "test_brownout_ladder_and_hysteresis",
    "test_service_deadline_504",
    "test_service_invalid_timeout_is_400",
    "test_service_timeout_zero_is_a_real_deadline",
)
CASES = expand("test_resilience", skip=SKIP)


def test_reference_cases_are_all_listed():
    # 44 cases less the 6 already held; two run at two parameters
    assert len(CASES) == 44 - 6 + 1


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- both packages: hedged scans and the commit's trace context ---------------

class Package:
    """One package's entry points for the scenarios below."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            import paimon_tpu_torch as pkg
            from paimon_tpu_torch.fs import object_store, resilience
            from paimon_tpu_torch.obs import trace
            from paimon_tpu_torch.table import FileStoreTable
            from paimon_tpu_torch.types import BigIntType, DoubleType
            self.kw = {"device": "cpu"}
        else:
            import paimon_tpu as pkg
            from paimon_tpu.fs import object_store, resilience
            from paimon_tpu.obs import trace
            from paimon_tpu.table import FileStoreTable
            from paimon_tpu.types import BigIntType, DoubleType
            self.kw = {}
        self.pkg, self.os, self.res, self.trace = \
            pkg, object_store, resilience, trace
        self.Table, self.BigInt, self.Double = \
            FileStoreTable, BigIntType, DoubleType

    def schema(self, **opts):
        return (self.pkg.Schema.builder()
                .column("id", self.BigInt(False))
                .column("v", self.Double()).primary_key("id")
                .options({"bucket": "2", **opts}).build())

    def create(self, path, fio, **opts):
        return self.Table.create(path, self.schema(**opts), file_io=fio,
                                 **self.kw)

    def load(self, path, fio, dynamic=None):
        return self.Table.load(path, file_io=fio, dynamic_options=dynamic,
                               **self.kw)


def _fill(table, ids, seed):
    rng = np.random.default_rng(seed)
    wb = table.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({"id": pa.array(ids, pa.int64()),
                                "v": pa.array(rng.random(len(ids)))}))
        wb.new_commit().commit(w.prepare_commit())


def _hedged_scans(pkg: Package, root: str):
    store = pkg.os.LocalObjectStoreBackend(root)
    plain = pkg.create("objfs://t", pkg.os.ObjectStoreFileIO(store))
    for s in range(3):
        _fill(plain, np.arange(s * 200, s * 200 + 400), seed=s)
    expected = plain.to_arrow().sort_by("id")
    lat = pkg.os.LatencyInjectingObjectStoreBackend(
        store, base_ms=0.5, seed=7, tail_rate=0.1, tail_multiplier=50.0)
    chaos = pkg.load("objfs://t", pkg.os.ObjectStoreFileIO(lat), {
        "read.hedge.enabled": "true", "read.hedge.min-delay": "1",
        "read.hedge.max-ratio": "0.3", "store.breaker.enabled": "true"})
    res = chaos.file_io.backend
    assert isinstance(res, pkg.res.ResilientObjectStoreBackend)
    res.tracker = pkg.res.LatencyTracker(min_samples=5)
    for _ in range(4):
        assert chaos.to_arrow().sort_by("id").equals(expected)
    assert lat.stats["tail_hits"] > 0
    return expected


def test_chaos_hedged_scan_byte_identical_across_packages(tmp_path):
    port = _hedged_scans(Package("port"), str(tmp_path / "p"))
    ref = _hedged_scans(Package("reference"), str(tmp_path / "r"))
    assert port.equals(ref)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_commit_in_span_stamps_trace_context(tmp_path, pkg):
    p = Package(pkg)
    p.trace.enable_tracing()
    try:
        t = p.create(str(tmp_path / "t"), None)
        with p.trace.span("ingest", cat="test"):
            token = p.trace.current_context_token()
            _fill(t, np.arange(10), seed=1)
        # an explicit context wins over the ambient span
        with p.trace.span("ingest", cat="test"):
            wb = t.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(pa.table({"id": pa.array([1], pa.int64()),
                                        "v": pa.array([0.5])}))
                wb.new_commit().commit(
                    w.prepare_commit(),
                    properties={"trace.context": "explicit"})
        # and outside a span nothing is stamped
        _fill(t, np.arange(5), seed=2)
    finally:
        p.trace.disable_tracing()
    props = [t.snapshot_manager.snapshot(i).properties for i in (1, 2, 3)]
    assert token is not None and \
        token == f"{p.trace.process_tag()}:{token.rsplit(':', 1)[1]}"
    assert props[0] == {"trace.context": token}
    assert props[1] == {"trace.context": "explicit"}
    assert not (props[2] or {}).get("trace.context")


def test_trace_context_property_equal_across_packages(tmp_path):
    """The same key and the same `<process tag>:<span id>` shape, with
    each package's own process tag."""
    shapes = []
    for pkg in ("port", "reference"):
        p = Package(pkg)
        p.trace.enable_tracing()
        try:
            t = p.create(str(tmp_path / pkg), None)
            with p.trace.span("ingest", cat="test"):
                _fill(t, np.arange(10), seed=1)
        finally:
            p.trace.disable_tracing()
        props = t.latest_snapshot().properties
        tag, _, sid = props["trace.context"].rpartition(":")
        assert tag == p.trace.process_tag() and sid.isdigit()
        shapes.append(sorted(props))
    assert shapes[0] == shapes[1] == ["trace.context"]
