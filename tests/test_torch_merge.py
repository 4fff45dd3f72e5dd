"""paimon_tpu_torch.ops.merge against paimon_tpu.ops.merge.

The port's device path (device="cpu": torch ops plus the kernel's plain
version) is held against the reference's device path, pinned with
PAIMON_FORCE_DEVICE_SORT=1 (Pallas in interpret mode on the CPU).  Inputs
are made with numpy from a seed and handed to both.  Every value
compared is an integer index, a mask or a table row, so equality is
exact (no tolerance).
"""

import numpy as np
import pyarrow as pa
import pytest

from paimon_tpu.ops import merge as ref
from paimon_tpu.types import RowKind
from paimon_tpu_torch.ops import merge as port
from paimon_tpu_torch.ops.merge_stream import merge_runs_streamed
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder

SEQ, KIND = port.SEQ_COL, port.KIND_COL


@pytest.fixture
def ref_device(monkeypatch):
    monkeypatch.setenv("PAIMON_FORCE_DEVICE_SORT", "1")


def _same(a, b):
    for what, x, y in zip(("perm", "winner", "prev"), a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, what
        np.testing.assert_array_equal(x.astype(np.int64),
                                      y.astype(np.int64), err_msg=what)


def _lanes(rng, n, num_lanes, hi=12):
    return rng.integers(0, hi, (n, num_lanes), dtype=np.uint64) \
        .astype(np.uint32)


@pytest.mark.parametrize("winners_only", [False, True])
@pytest.mark.parametrize("keep", ["last", "first"])
@pytest.mark.parametrize("num_lanes", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_sorted_winners_match_reference_device_path(ref_device, seed,
                                                    num_lanes, keep,
                                                    winners_only):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(100, 3000))
    lanes = _lanes(rng, n, num_lanes)
    seq = rng.permutation(n).astype(np.int64)
    want = ref.device_sorted_winners(lanes, seq, keep,
                                     winners_only=winners_only)
    got = port.device_sorted_winners(lanes, seq, keep,
                                     winners_only=winners_only, device="cpu")
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_packed_key_upload_matches_lanes(ref_device, seed):
    """The packed u64 key (one fixed-width column) uploads in place of
    the lane matrix and gives the same arrays."""
    rng = np.random.default_rng(seed)
    n = 2500
    keys = rng.integers(-(1 << 62), 1 << 62, n)
    t = pa.table({"k": pa.array(keys, pa.int64())})
    enc = NormalizedKeyEncoder([pa.int64()], nullable=[False])
    lanes, _, packed = enc.encode_table_ex(t, ["k"])
    seq = np.arange(n, dtype=np.int64)
    want = ref.device_sorted_winners(np.asarray(lanes), seq, "last",
                                     winners_only=True)
    got = port.device_sorted_winners(lanes, seq, "last", winners_only=True,
                                     packed=packed, device="cpu")
    _same(got, want)


@pytest.mark.parametrize("keep", ["last", "first"])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_order_lanes_match_reference(ref_device, seed, keep):
    rng = np.random.default_rng(seed)
    n = 1500
    lanes = _lanes(rng, n, 2, hi=20)
    order_lanes = _lanes(rng, n, 2, hi=4)
    seq = rng.permutation(n).astype(np.int64)
    want = ref.device_sorted_winners(lanes, seq, keep, order_lanes)
    got = port.device_sorted_winners(lanes, seq, keep, order_lanes,
                                     device="cpu")
    _same(got, want)


@pytest.mark.parametrize("keep", ["last", "first"])
@pytest.mark.parametrize("num_lanes", [2, 4])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_ovc_full_order_matches_reference(ref_device, seed, num_lanes, keep):
    """Full-order path with run boundaries: offset-value codes ride the
    sort into the kernel's code variant."""
    rng = np.random.default_rng(seed)
    k = 5
    runs = []
    for _ in range(k):
        m = int(rng.integers(50, 800))
        part = _lanes(rng, m, num_lanes, hi=6)
        runs.append(part[np.lexsort(part.T[::-1])])
    lanes = np.concatenate(runs)
    n = len(lanes)
    starts = np.concatenate([[0], np.cumsum([len(r) for r in runs])]) \
        .astype(np.int64)
    seq = np.arange(n, dtype=np.int64)
    want = ref.device_sorted_winners(lanes, seq, keep, run_starts=starts)
    got = port.device_sorted_winners(lanes, seq, keep, run_starts=starts,
                                     device="cpu")
    _same(got, want)


def test_padding_never_joins_segments():
    lanes = np.zeros((5, 2), dtype=np.uint32)
    seq = np.arange(5, dtype=np.int64)
    perm, winner, _ = port.device_sorted_winners(lanes, seq, "last",
                                                 device="cpu")
    assert perm[winner & (perm < 5)].tolist() == [4]


# -- merge_runs: ported cases of tests/test_merge_ops.py ----------------------

def make_run(keys, seqs, kinds=None, values=None, key_type=pa.int64()):
    n = len(keys)
    return pa.table({
        "k": pa.array(keys, key_type),
        SEQ: pa.array(seqs, pa.int64()),
        KIND: pa.array(kinds if kinds is not None
                       else [RowKind.INSERT] * n, pa.int8()),
        "v": pa.array(values if values is not None else list(range(n)),
                      pa.int64()),
    })


def _random_runs(seed):
    rng = np.random.default_rng(seed)
    runs, seq = [], 0
    for _ in range(int(rng.integers(2, 6))):
        n = int(rng.integers(1, 500))
        kinds = rng.choice([RowKind.INSERT, RowKind.UPDATE_AFTER,
                            RowKind.DELETE], n, p=[0.6, 0.25, 0.15])
        runs.append(make_run(rng.integers(-50, 50, n).tolist(),
                             list(range(seq, seq + n)), kinds.tolist(),
                             rng.integers(0, 10**9, n).tolist()))
        seq += n
    return runs


def _str_run(keys):
    return pa.table({"k": pa.array(keys, pa.string()),
                     SEQ: pa.array(range(len(keys)), pa.int64()),
                     KIND: pa.array([0] * len(keys), pa.int8()),
                     "v": pa.array(range(len(keys)), pa.int64())})


_X = "x" * 20
MERGE_CASES = {
    "single_run": lambda: ([make_run([1, 2, 2, 3], [0, 1, 2, 3],
                                     values=[10, 20, 21, 30])], ["k"], {}),
    "latest_wins": lambda: ([make_run([1, 2, 3], [0, 1, 2]),
                             make_run([2, 3], [3, 4])], ["k"], {}),
    "delete_drops": lambda: ([make_run([1, 2], [0, 1]),
                              make_run([1], [2], kinds=[RowKind.DELETE])],
                             ["k"], {}),
    "delete_kept": lambda: ([make_run([1, 2], [0, 1]),
                             make_run([1], [2], kinds=[RowKind.DELETE])],
                            ["k"], {"drop_deletes": False}),
    "equal_seq_later_run": lambda: ([make_run([1], [5], values=[100]),
                                     make_run([1], [5], values=[200])],
                                    ["k"], {}),
    "first_row": lambda: ([make_run([1, 2], [0, 1]),
                           make_run([1, 2], [2, 3])], ["k"],
                          {"merge_engine": "first-row"}),
    "extreme_ints": lambda: ([make_run([-(1 << 63), -(1 << 62), -1, 0, 1,
                                        (1 << 63) - 1, -(1 << 63)],
                                       list(range(7)))], ["k"], {}),
    "floats": lambda: ([make_run([3.5, -2.25, 0.0, -1e300, 1e300, 0.0],
                                 list(range(6)), key_type=pa.float64())],
                       ["k"], {}),
    "short_strings": lambda: ([_str_run(["banana", "apple", "cherry",
                                         "apple"])], ["k"], {}),
    "truncated_strings": lambda: ([_str_run([_X + "bbb", _X + "aaa",
                                             _X + "bbb", "short"])],
                                  ["k"], {}),
    "truncated_with_prev": lambda: ([_str_run([_X + "b", _X + "a"]),
                                     _str_run([_X + "b", "short"])],
                                    ["k"], {"with_prev": True}),
    "composite": lambda: ([pa.table({
        "a": pa.array([1, 1, 2, 2], pa.int32()),
        "b": pa.array(["x", "y", "x", "x"], pa.string()),
        SEQ: pa.array(range(4), pa.int64()),
        KIND: pa.array([0] * 4, pa.int8()),
        "v": pa.array(range(4), pa.int64())})], ["a", "b"], {}),
    "nullable_key": lambda: ([pa.table({
        "k": pa.array([5, None, (1 << 63) - 1, None, 5], pa.int64()),
        SEQ: pa.array(range(5), pa.int64()),
        KIND: pa.array([0] * 5, pa.int8()),
        "v": pa.array(range(5), pa.int64())})], ["k"], {}),
    "with_prev": lambda: (_random_runs(3), ["k"], {"with_prev": True}),
    "random_0": lambda: (_random_runs(0), ["k"], {}),
    "random_1": lambda: (_random_runs(1), ["k"], {}),
    "random_2_first_row": lambda: (_random_runs(2), ["k"],
                                   {"merge_engine": "first-row"}),
}


@pytest.mark.parametrize("device_path", [False, True])
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_runs_matches_reference(monkeypatch, case, device_path):
    if device_path:
        monkeypatch.setenv("PAIMON_FORCE_DEVICE_SORT", "1")
    runs, keys, kw = MERGE_CASES[case]()
    want = ref.merge_runs(runs, keys, **kw)
    got = port.merge_runs(runs, keys, device="cpu", **kw)
    np.testing.assert_array_equal(got.indices, want.indices)
    if kw.get("with_prev"):
        np.testing.assert_array_equal(got.prev_indices, want.prev_indices)
    assert got.take().equals(want.take())


@pytest.mark.parametrize("device_path", [False, True])
@pytest.mark.parametrize("case", ["random_0", "extreme_ints", "floats",
                                  "short_strings", "truncated_strings",
                                  "composite", "nullable_key"])
def test_sort_table_matches_reference(monkeypatch, case, device_path):
    """Full (key, seq) sort permutation of one table, truncated string
    keys re-sorted by full key on the host."""
    if device_path:
        monkeypatch.setenv("PAIMON_FORCE_DEVICE_SORT", "1")
    runs, keys, _ = MERGE_CASES[case]()
    table = pa.concat_tables(runs)
    want = ref.sort_table(table, keys)
    got = port.sort_table(table, keys, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_streamed_windows_equal_one_shot():
    """merge_stream cuts key windows; merging each with the port's
    merge_runs equals one merge of everything."""
    runs = [r.sort_by([("k", "ascending"), (SEQ, "ascending")])
            for r in _random_runs(7)]
    enc = NormalizedKeyEncoder([pa.int64()], nullable=[False])
    out = []
    merge_runs_streamed(
        [iter([r.slice(i, 37) for i in range(0, r.num_rows, 37)])
         for r in runs], ["k"], enc, out.append,
        lambda tables: port.merge_runs(tables, ["k"], key_encoder=enc,
                                       device="cpu").take(),
        window_rows=16)
    one = port.merge_runs(runs, ["k"], device="cpu").take()
    assert pa.concat_tables(out).equals(one)


def test_unported_engine_raises():
    with pytest.raises(NotImplementedError, match="ops.agg.merge_runs_agg"):
        port.merge_runs([make_run([1], [0])], ["k"],
                        merge_engine="aggregation")
