"""The port's merge routes against the reference's same routes.

paimon_tpu_torch.ops.merge.device_sorted_winners has the reference's
six routes: device full, device packed, device bitmask (the device ones
on device="cpu" run torch ops and the kernel's plain version), host
native radix, host numpy, host general lexsort and host offset-value
coded merge.  Each route is pinned the same way in both packages
(PAIMON_FORCE_DEVICE_SORT, PAIMON_FORCE_HOST_SORT,
PAIMON_FORCE_BITMASK_SORT, PAIMON_DISABLE_NATIVE, PAIMON_DISABLE_OVC)
and the outputs, made from the same seeded numpy inputs, are held
equal exactly: they are indices and masks.  The cost model must decide
as the reference's does on the same link rates and constants, and the
port's C library (its own copy, built into paimon_tpu_torch/_build/)
must compute what the reference's does.  The routing state is module
global, so every test resets it.
"""

import os

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu import native as ref_native
from paimon_tpu.ops import merge as ref
from paimon_tpu.ops import ovc as ref_ovc
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import DoubleType as RefDouble
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch import native
from paimon_tpu_torch.ops import merge as port
from paimon_tpu_torch.ops import ovc
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType

SWITCHES = ("PAIMON_FORCE_DEVICE_SORT", "PAIMON_FORCE_HOST_SORT",
            "PAIMON_FORCE_BITMASK_SORT", "PAIMON_DISABLE_NATIVE",
            "PAIMON_DISABLE_OVC")
ROUTE_KEYS = ("host", "device", "ovc")


@pytest.fixture(autouse=True)
def fresh_routing(monkeypatch):
    """Fresh routing state in both packages, no switch set."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for mod in (port, ref):
        monkeypatch.setattr(mod, "_LINK_BW", None)
        monkeypatch.setattr(mod, "_WINNER_FRAC", {"num": 0.0, "den": 0.0})
        monkeypatch.setattr(mod, "PATH_COUNTS", dict.fromkeys(
            mod.PATH_COUNTS, 0))
    for mod in (ovc, ref_ovc):
        monkeypatch.setattr(mod, "OVC_PATH_ROWS", {"rows": 0, "merges": 0})


def switch(monkeypatch, *names):
    for name in names:
        monkeypatch.setenv(name, "1")
    if "PAIMON_DISABLE_NATIVE" in names:
        # the reference reads the switch when it first loads its library
        monkeypatch.setattr(ref_native, "_lib", None)
        monkeypatch.setattr(ref_native, "_tried", False)


def runs_input(seed, n, runs=10, dupes=2, sorted_runs=True):
    """Packed BIGINT keys in `runs` runs, each (key, seq)-sorted when
    `sorted_runs`: (lanes u32[n, 2], seq, packed u64, run_starts)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-n // dupes, n // dupes, n)
    starts = np.linspace(0, n, runs + 1).astype(np.int64)
    if sorted_runs:
        for a, b in zip(starts[:-1], starts[1:]):
            ids[a:b] = np.sort(ids[a:b])
    packed = ids.view(np.uint64) ^ np.uint64(1 << 63)
    lanes = np.stack([(packed >> np.uint64(32)).astype(np.uint32),
                      (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=1)
    return lanes, np.arange(n, dtype=np.int64), packed, starts


def both(lanes, seq, keep, **kw):
    """(port result, reference result, port route deltas, reference
    route deltas) of one call with the same inputs."""
    before = (dict(port.PATH_COUNTS), dict(ref.PATH_COUNTS))
    got = port.device_sorted_winners(lanes, seq, keep, device="cpu", **kw)
    want = ref.device_sorted_winners(lanes, seq, keep, **kw)
    deltas = tuple({k: counts[k] - b[k] for k in ROUTE_KEYS}
                   for counts, b in zip((port.PATH_COUNTS, ref.PATH_COUNTS),
                                        before))
    return got, want, deltas


def same(got, want):
    for what, x, y in zip(("perm", "winner", "prev"), got, want):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, what
        np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64),
                                      err_msg=what)


# -- every route, pinned the same way in both packages ----------------------

ROUTES = {
    # name: (switches, winners_only, pass packed, pass run_starts, route)
    "device full": (("PAIMON_FORCE_DEVICE_SORT",), False, True, False,
                    "device"),
    "device full, run codes": (("PAIMON_FORCE_DEVICE_SORT",), False, True,
                               True, "device"),
    "device packed": (("PAIMON_FORCE_DEVICE_SORT",), True, True, False,
                      "device"),
    "bitmask": (("PAIMON_FORCE_BITMASK_SORT",), True, True, False,
                "device"),
    "host native fast": (("PAIMON_FORCE_HOST_SORT",), True, True, False,
                         "host"),
    "host numpy fast": (("PAIMON_FORCE_HOST_SORT", "PAIMON_DISABLE_NATIVE"),
                        True, True, False, "host"),
    "host native full order": (("PAIMON_FORCE_HOST_SORT",), False, True,
                               False, "host"),
    "host general": (("PAIMON_FORCE_HOST_SORT",), False, False, False,
                     "host"),
    "host ovc": (("PAIMON_FORCE_HOST_SORT",), False, True, True, "ovc"),
    "host ovc, lanes": (("PAIMON_FORCE_HOST_SORT",), False, False, True,
                        "ovc"),
    "host ovc off": (("PAIMON_FORCE_HOST_SORT", "PAIMON_DISABLE_OVC"),
                     False, True, True, "host"),
}


@pytest.mark.parametrize("keep", ["last", "first"])
@pytest.mark.parametrize("seed, n", [(0, 3000), (1, 777), (2, 5000)])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_reference(monkeypatch, route, seed, n, keep):
    switches, winners_only, with_packed, with_runs, taken = ROUTES[route]
    switch(monkeypatch, *switches)
    lanes, seq, packed, starts = runs_input(seed, n)
    got, want, (d_port, d_ref) = both(
        lanes, seq, keep, winners_only=winners_only,
        packed=packed if with_packed else None,
        run_starts=starts if with_runs else None)
    same(got, want)
    assert d_port == d_ref
    assert d_port[taken] == 1
    if route == "bitmask":
        assert port.PATH_COUNTS["bitmask"] == 1
        assert np.asarray(got[1]).all()


def test_unsorted_runs_leave_the_ovc_route(monkeypatch):
    """A run that breaks its (key, seq) order sends the OVC route to the
    sort, in both packages, with the same result."""
    switch(monkeypatch, "PAIMON_FORCE_HOST_SORT")
    lanes, seq, packed, starts = runs_input(4, 4000, sorted_runs=False)
    got, want, (d_port, d_ref) = both(lanes, seq, "last",
                                      packed=packed, run_starts=starts)
    same(got, want)
    assert d_port == d_ref == {"host": 1, "device": 0, "ovc": 0}


@pytest.mark.parametrize("seed", [3, 8])
def test_host_route_with_order_lanes(monkeypatch, seed):
    switch(monkeypatch, "PAIMON_FORCE_HOST_SORT")
    rng = np.random.default_rng(seed)
    n = 2500
    lanes = rng.integers(0, 40, (n, 1), dtype=np.uint64).astype(np.uint32)
    order = rng.integers(0, 4, (n, 1), dtype=np.uint64).astype(np.uint32)
    seq = rng.permutation(n).astype(np.int64)
    got, want, (d_port, d_ref) = both(lanes, seq, "last",
                                      order_lanes=order)
    same(got, want)
    assert d_port == d_ref == {"host": 1, "device": 0, "ovc": 0}


def test_cpu_keeps_the_device_route_without_a_switch():
    """On device="cpu" the port runs its device route (the kernels'
    plain versions), whatever the model would say; the reference takes
    the host on its CPU backend."""
    lanes, seq, packed, starts = runs_input(5, 3000)
    got, want, (d_port, d_ref) = both(lanes, seq, "last",
                                      winners_only=True, packed=packed)
    assert d_port == {"host": 0, "device": 1, "ovc": 0}
    assert d_ref == {"host": 1, "device": 0, "ovc": 0}
    assert len(got[0]) == 4096 and len(want[0]) == 3000
    n = len(seq)
    assert set(got[0][got[1] & (got[0] < n)].tolist()) == \
        set(want[0][want[1]].tolist())


def test_routing_state_under_concurrent_merges(monkeypatch):
    """Merge workers update the route counts and the winner fraction
    concurrently; no update may be lost."""
    import sys
    import threading
    switch(monkeypatch, "PAIMON_FORCE_HOST_SORT")
    lanes, seq, packed, _ = runs_input(14, 64)
    winners = int(np.count_nonzero(port.device_sorted_winners(
        lanes, seq, "last", winners_only=True, packed=packed,
        device="cpu")[1]))
    monkeypatch.setattr(port, "_WINNER_FRAC", {"num": 0.0, "den": 0.0})
    monkeypatch.setattr(port, "PATH_COUNTS", dict.fromkeys(port.PATH_COUNTS,
                                                           0))
    calls, workers = 300, 16

    def work():
        for _ in range(calls):
            port.device_sorted_winners(lanes, seq, "last", winners_only=True,
                                       packed=packed, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert port.PATH_COUNTS["host"] == calls * workers
    assert port._WINNER_FRAC == {"num": float(winners * calls * workers),
                                 "den": float(64 * calls * workers)}


# -- the cost model ----------------------------------------------------------

LINKS = [(24e9, 20e9), (8e9, 8e9), (900e6, 8e6), (2e9, 300e6)]


@pytest.fixture
def same_constants(monkeypatch):
    for name in ("_DEVICE_SORT_ROWS_PER_SEC", "_HOST_FAST_NUMPY_ROWS_PER_SEC",
                 "_HOST_FAST_NATIVE_ROWS_PER_SEC",
                 "_HOST_GENERAL_ROWS_PER_SEC"):
        monkeypatch.setattr(port, name, getattr(ref, name))


@pytest.mark.parametrize("link", LINKS)
def test_cost_model_decides_as_the_reference(monkeypatch, same_constants,
                                             link):
    for mod in (port, ref):
        monkeypatch.setattr(mod, "_LINK_BW", link)
    for n in (1 << 10, 5000, 1 << 14, 1 << 20, 5_000_000, 1 << 24):
        for lanes in (2, 3, 6):
            for winners_only in (False, True):
                for host_fast in (False, True):
                    assert port._device_path_pays(
                        n, lanes, winners_only, host_fast) == \
                        ref._device_path_pays(n, lanes, winners_only,
                                              host_fast)
    for frac in (None, (43.0, 100.0), (1.0, 100.0), (99.0, 100.0)):
        num, den = frac or (0.0, 0.0)
        for mod in (port, ref):
            monkeypatch.setattr(mod, "_WINNER_FRAC",
                                {"num": num, "den": den})
        assert port._observed_winner_frac() == ref._observed_winner_frac()
        for n in (1 << 14, 1 << 20, 1 << 24):
            for overlapped in (False, True):
                assert port._bitmask_device_pays(n, 2, overlapped) == \
                    ref._bitmask_device_pays(n, 2, overlapped)


def test_winner_fraction_moves_only_on_host_fast_and_bitmask(monkeypatch):
    """The reference's state: the native fused host route and the
    bitmask route update the observed winner fraction, the device
    packed and full routes do not."""
    lanes, seq, packed, _ = runs_input(6, 4000)
    switch(monkeypatch, "PAIMON_FORCE_DEVICE_SORT")
    for mod, kw in ((port, {"device": "cpu"}), (ref, {})):
        mod.device_sorted_winners(lanes, seq, "last", winners_only=True,
                                  packed=packed, **kw)
    assert port._observed_winner_frac() == ref._observed_winner_frac() == 1.0
    monkeypatch.delenv("PAIMON_FORCE_DEVICE_SORT")
    for env in ("PAIMON_FORCE_HOST_SORT", "PAIMON_FORCE_BITMASK_SORT"):
        monkeypatch.setenv(env, "1")
        for mod, kw in ((port, {"device": "cpu"}), (ref, {})):
            mod.device_sorted_winners(lanes, seq, "last", winners_only=True,
                                      packed=packed, **kw)
        monkeypatch.delenv(env)
    assert port._WINNER_FRAC == ref._WINNER_FRAC
    assert 0.05 < port._observed_winner_frac() < 1.0


def test_cuda_routing_follows_the_model(monkeypatch):
    """On a CUDA device the model picks the route.  In a fresh process
    (winner fraction 1.0) the bitmask return never pays, and a
    tunnel-like link sends a winners-only merge to the host without
    touching the card; that host merge lowers the observed winner
    fraction, after which the model picks the bitmask return for the
    same merge, as the reference's state does."""
    import torch
    monkeypatch.setattr(port, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(port, "_LINK_BW", (900e6, 8e6))
    lanes, seq, packed, starts = runs_input(7, 1 << 16)
    n = len(seq)
    assert not port._bitmask_device_pays(n, 2, True)
    perm, winner, _ = port.device_sorted_winners(
        lanes, seq, "last", winners_only=True, packed=packed,
        overlapped=True)
    assert port.PATH_COUNTS == {"host": 1, "device": 0, "ovc": 0,
                                "bitmask": 0}
    assert len(perm) == n
    assert port._observed_winner_frac() == np.count_nonzero(winner) / n
    assert port._observed_winner_frac() < 1.0
    assert port._bitmask_device_pays(n, 2, True)


# -- every caller under the host and bitmask routes --------------------------

def kv_runs(seed, runs=4, per=1500, string_keys=False):
    rng = np.random.default_rng(seed)
    out, seq0 = [], 0
    for _ in range(runs):
        ids = np.sort(rng.integers(0, per, per))
        key = pa.array([("x" * 20 + f"{v:05d}") if v % 3 == 0 else f"s{v}"
                        for v in ids.tolist()]) if string_keys \
            else pa.array(ids, pa.int64())
        key_name = "_KEY_s" if string_keys else "_KEY_id"
        t = pa.table({key_name: key,
                      "_SEQUENCE_NUMBER": pa.array(
                          np.arange(seq0, seq0 + per), pa.int64()),
                      "_VALUE_KIND": pa.array(
                          rng.choice([0, 0, 0, 2, 3], per).astype(np.int8)),
                      "v": pa.array(rng.random(per))})
        if string_keys:
            t = t.sort_by([(key_name, "ascending"),
                           ("_SEQUENCE_NUMBER", "ascending")])
        out.append(t)
        seq0 += per
    return out


CALLER_SWITCHES = ["PAIMON_FORCE_HOST_SORT", "PAIMON_FORCE_BITMASK_SORT"]


@pytest.mark.parametrize("engine", ["deduplicate", "first-row"])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("string_keys", [False, True])
@pytest.mark.parametrize("env", CALLER_SWITCHES)
def test_merge_runs_under_a_switch(monkeypatch, env, string_keys, with_prev,
                                   engine):
    """merge_runs, with `_refine_truncated` on string keys longer than
    the lane prefix, selects through the winner mask and `perm < n`."""
    switch(monkeypatch, env)
    runs = kv_runs(9, string_keys=string_keys)
    key = "_KEY_s" if string_keys else "_KEY_id"
    got = port.merge_runs(runs, [key], merge_engine=engine,
                          with_prev=with_prev, device="cpu")
    want = ref.merge_runs(runs, [key], merge_engine=engine,
                          with_prev=with_prev)
    np.testing.assert_array_equal(got.indices, want.indices)
    if with_prev:
        np.testing.assert_array_equal(got.prev_indices, want.prev_indices)
    assert got.take().equals(want.take())


@pytest.mark.parametrize("string_keys", [False, True])
@pytest.mark.parametrize("env", CALLER_SWITCHES)
def test_sort_table_under_a_switch(monkeypatch, env, string_keys):
    switch(monkeypatch, env)
    table = pa.concat_tables(kv_runs(10, string_keys=string_keys))
    key = "_KEY_s" if string_keys else "_KEY_id"
    np.testing.assert_array_equal(
        port.sort_table(table, [key], device="cpu"),
        ref.sort_table(table, [key]))


def _tables(tmp_path, options, string_keys=False):
    key_t = (VarCharType, RefVarChar) if string_keys \
        else (BigIntType, RefBigInt)
    port_t = FileStoreTable.create(
        str(tmp_path / "port"),
        Schema.builder().column("id", key_t[0](nullable=False))
        .column("v", BigIntType()).column("d", DoubleType())
        .primary_key("id").options(options).build(), device="cpu")
    ref_t = RefTable.create(
        str(tmp_path / "ref"),
        RefSchema.builder().column("id", key_t[1](nullable=False))
        .column("v", RefBigInt()).column("d", RefDouble())
        .primary_key("id").options(options).build())
    return port_t, ref_t


def _write(table, seed, string_keys, commits=3, rows=2000):
    rng = np.random.default_rng(seed)
    for _ in range(commits):
        ids = rng.integers(0, rows, rows)
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(pa.table({
                "id": pa.array([("y" * 20 + str(i)) if i % 2 else str(i)
                                for i in ids.tolist()]) if string_keys
                else pa.array(ids, pa.int64()),
                "v": pa.array(rng.integers(0, 1000, rows), pa.int64()),
                "d": pa.array(rng.random(rows))}))
            wb.new_commit().commit(w.prepare_commit())


ENGINES = {
    "deduplicate": {},
    "aggregation": {"merge-engine": "aggregation",
                    "fields.v.aggregate-function": "sum",
                    "fields.d.aggregate-function": "max"},
    "partial-update": {"merge-engine": "partial-update"},
}


@pytest.mark.parametrize("string_keys", [False, True])
@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("env", CALLER_SWITCHES)
def test_table_callers_under_a_switch(tmp_path, monkeypatch, env, engine,
                                      string_keys):
    """Write (sort_table or merge_runs), merge-on-read scan (merge_runs
    or ops/agg), streamed and one-shot full compaction, the same rows as
    the reference under the same switch."""
    switch(monkeypatch, env)
    options = {"bucket": "1", "write-only": "true",
               "tpu.merge.stream-threshold-rows": "2048",
               "tpu.merge.chunk-rows": "512", **ENGINES[engine]}
    port_t, ref_t = _tables(tmp_path, options, string_keys)
    for t in (port_t, ref_t):
        _write(t, 12, string_keys)
    assert port_t.to_arrow().sort_by("id").equals(
        ref_t.to_arrow().sort_by("id"))
    port_t.compact(full=True)
    ref_t.compact(full=True)
    assert port_t.to_arrow().sort_by("id").equals(
        ref_t.to_arrow().sort_by("id"))


# -- the port's own C library ------------------------------------------------

def test_native_library_is_the_ports_own():
    lib = native.load()
    assert lib is not None
    build_dir = os.path.join(os.path.dirname(native.__file__), os.pardir,
                             "_build")
    assert lib._name == native.LIB_PATH
    assert os.path.dirname(lib._name) == os.path.realpath(build_dir)


def test_native_switch_is_read_on_every_call(monkeypatch):
    assert native.load() is not None
    monkeypatch.setenv("PAIMON_DISABLE_NATIVE", "1")
    assert native.load() is None
    assert not native.predicted_available()
    assert native.radix_argsort(np.zeros(4, np.uint64)) is None
    monkeypatch.delenv("PAIMON_DISABLE_NATIVE")
    assert native.load() is not None


@pytest.mark.parametrize("n", [0, 1, 2, 1000, 100_000])
def test_native_radix_matches_reference(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(n // 3, 1), n).astype(np.uint64) \
        << np.uint64(32) | rng.integers(0, 1 << 31, n).astype(np.uint64)
    np.testing.assert_array_equal(native.radix_argsort(keys),
                                  ref_native.radix_argsort(keys))


@pytest.mark.parametrize("keep_last", [True, False])
def test_native_winners_match_reference(keep_last):
    rng = np.random.default_rng(2)
    n = 30_000
    keys = rng.integers(0, n // 4, n).astype(np.uint64)
    seq = rng.integers(0, 1000, n).astype(np.int64)
    for a, b in zip(native.merge_winners(keys, seq, keep_last),
                    ref_native.merge_winners(keys, seq, keep_last)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sorted_runs", [True, False])
def test_native_ovc_matches_reference(sorted_runs):
    lanes, seq, packed, starts = runs_input(13, 20_000,
                                            sorted_runs=sorted_runs)
    for name, args in (("ovc_codes_u64", (packed, seq, starts)),
                       ("ovc_codes_lanes", (lanes, seq, starts)),
                       ("ovc_merge_u64", (packed, seq, starts)),
                       ("ovc_merge_lanes", (lanes, seq, starts))):
        got = getattr(native, name)(*args)
        want = getattr(ref_native, name)(*args)
        assert (got is None) == (want is None) == (not sorted_runs), name
        if got is not None:
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(a, b)
