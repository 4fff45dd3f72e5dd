"""The data loaders of paimon_tpu_torch against paimon_tpu.

The 9 cases of tests/test_integrations.py (the torch IterableDataset's
full pass, DataLoader workers, rank sharding and predicate pushdown;
`jax_batches`' fixed shapes, its masked tail and its refusal of
non-numeric columns; the split tasks and the ray/daft import gates) run
on both packages (tests/test_torch_object_store.py `run_case`).  The
port's `jax_batches` yields tensors on the table's device where the
reference's yields jax arrays.

On one table, read through both packages: the port's `jax_batches` on
`device="cpu"` yields the reference's batches (jax's CPU backend)
exactly, in order, with the same dtypes; sharded over two CPU devices
its shards concatenate to the unsharded batch.  `_to_torch_batch` gives
the reference's tensors (integer columns with nulls as float64 with
NaN) without the warning `torch.from_numpy` gives for Arrow's read-only
buffers.  A DataLoader's `spawn` workers load the table again and see
every row once.
"""

import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

from paimon_tpu.integrations import jax_data as ref_jax_data
from paimon_tpu.integrations import torch_data as ref_torch_data
from paimon_tpu_torch.integrations import jax_data, torch_data
from tests.test_torch_dynamic_bucket import PORT, REF, commit_arrow
from tests.test_torch_object_store import expand, run_case
from tests.test_torch_vector import case_ids

CASES = expand("test_integrations")


def test_reference_cases_are_all_listed():
    assert len(CASES) == 9


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- one table, both packages' loaders ------------------------------------------

ROWS = 5_000


def _table(root):
    """A 4-bucket append table written by the reference from seed 9:
    BIGINT, DOUBLE, INT with nulls, BOOLEAN and STRING columns in 3
    commits.  -> (the reference's table, the port's over the same
    directory, on the CPU)."""
    schema = REF.schema([("id", "BigIntType", False),
                         ("v", "DoubleType", True),
                         ("n", "IntType", True),
                         ("b", "BooleanType", True),
                         ("s", "VarCharType", True)], pk=(),
                        options={"bucket": "4", "bucket-key": "id"})
    t = REF.create(root, schema)
    rng = np.random.default_rng(9)
    for k in range(3):
        n = ROWS // 3 + k
        commit_arrow(t, pa.table({
            "id": pa.array(rng.permutation(n) + k * ROWS, pa.int64()),
            "v": pa.array(rng.normal(size=n)),
            "n": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                          mask=rng.random(n) < 0.2),
            "b": pa.array(rng.random(n) < 0.5),
            "s": pa.array([f"s{i}" for i in rng.integers(0, 99, n)])}))
    return t, PORT.Table.load(t.path, **PORT.kwargs)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("projection", [None, ["v", "id", "b"]])
def test_jax_batches_equal_reference(tmp_path, projection, drop_remainder):
    ref, port = _table(str(tmp_path))
    kw = dict(projection=projection, drop_remainder=drop_remainder)
    want = list(ref_jax_data.jax_batches(ref, 512, **kw))
    got = list(jax_data.jax_batches(port, 512, **kw))
    assert len(got) == len(want) == (ROWS // 512 + (not drop_remainder))
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].device == torch.device("cpu")
            a = np.asarray(w[k])
            assert g[k].numpy().dtype == a.dtype, k
            assert np.array_equal(g[k].numpy(), a, equal_nan=True), k


def test_sharded_batches_concatenate_to_unsharded(tmp_path):
    _, port = _table(str(tmp_path))
    cpus = [torch.device("cpu")] * 2
    plain = list(jax_data.jax_batches(port, 512, drop_remainder=False))
    sharded = list(jax_data.jax_batches(port, 512, drop_remainder=False,
                                        sharding=cpus))
    assert len(plain) == len(sharded)
    for p, s in zip(plain, sharded):
        assert list(p) == list(s)
        for k in p:
            assert [x.shape[0] for x in s[k]] == [256, 256]
            assert torch.equal(torch.cat(s[k]).nan_to_num(nan=-7.0),
                               p[k].nan_to_num(nan=-7.0))
    with pytest.raises(ValueError, match="does not divide"):
        next(jax_data.jax_batches(port, 512, sharding=[cpus[0]] * 3))


def test_to_torch_batch_equals_reference_without_warnings():
    t = pa.table({
        "i": pa.array([1, None, 3], pa.int64()),
        "j": pa.array([4, 5, 6], pa.int32()),
        "f": pa.array([0.5, None, 2.0]),
        "b": pa.array([True, False, True]),
        "s": pa.array(["a", None, "c"])})
    want = ref_torch_data._to_torch_batch(t)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = torch_data._to_torch_batch(t)
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[k].dtype == w.dtype
            assert torch.equal(torch.nan_to_num(got[k], nan=-7.0),
                               torch.nan_to_num(w, nan=-7.0)), k
        else:
            assert got[k] == w
    assert got["i"].dtype == torch.float64 and torch.isnan(got["i"][1])
    # the tensors own their memory
    got["j"][0] = 40
    assert t.column("j")[0].as_py() == 4
    # a boolean column with nulls: the reference raises on its object
    # array; the port gives float64 with NaN, as for integers
    nulls = pa.table({"b": pa.array([True, None, False])})
    with pytest.raises(TypeError):
        ref_torch_data._to_torch_batch(nulls)
    b = torch_data._to_torch_batch(nulls)["b"]
    assert b.dtype == torch.float64 and b[0] == 1 and b[2] == 0 and \
        torch.isnan(b[1])


def test_spawn_workers_see_every_row_once(tmp_path):
    """The dataset pickles as its table's path, options and device, so
    `spawn` workers (the context a table on the card uses) load the
    table again; each row is seen once."""
    _, port = _table(str(tmp_path))
    dl = torch_data.to_torch_dataloader(
        port, projection=["id", "n"], batch_size=700, num_workers=2,
        multiprocessing_context="spawn")
    ids = torch.cat([b["id"] for b in dl])
    assert sorted(ids.tolist()) == sorted(
        port.to_arrow().column("id").to_pylist())
    assert len(ids) == port.to_arrow().num_rows
