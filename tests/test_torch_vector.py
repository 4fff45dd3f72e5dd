"""The vector plane of paimon_tpu_torch (vector/ann.py) against paimon_tpu.

- The cases of tests/test_vector_search.py, test_ivfpq.py and
  test_ann_sq_hnsw.py run on both packages through
  tests/test_torch_append.py's `run_reference_case`, the port's tables
  and indexes on the CPU.
- Each of the four device programs (`_topk_scores`, `_kmeans`,
  `_kmeans_batch`, `_pq_encode`) is held to the reference's jitted
  function under the exactness rule below, and a near-tie case fixes the
  lower-index order of `jax.lax.top_k`.
- Index states, and persisted indexes, built by either package load in
  the other and search bit for bit alike: everything downstream of a
  given state is host numpy in both.
- The port never turns TF32 on: its products run in full float32.

The exactness rule (fixed before the first chip run): tau = 1e-5 *
max(1, |s|) on a float32 score s; two candidates whose reference scores
differ by at most tau are a near-tie.  Scores agree within tau; ids agree
position by position except inside a run of near-ties, where the sets
agree, and at the last position a near-tie may swap one id.  Centroids
from the same initial centroids agree within 1e-4 of the data's scale;
codes agree except where a vector's two nearest codewords are a
near-tie.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import paimon_tpu.vector.ann as ref_ann
import paimon_tpu_torch.vector.ann as ann
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import ArrayType as RefArray
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import FloatType as RefFloat
from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import ArrayType, BigIntType, FloatType
from tests.test_ivfpq import clustered, recall_at_k
from tests.test_torch_append import (reference_cases, reference_module,
                                     run_reference_case)

# -- the reference's cases on both packages -----------------------------------

# parametrized reference cases: (parameter, its values)
PARAMS = {"test_brute_force_matches_exact": ("metric",
                                             ("cosine", "dot", "l2")),
          "TestPersistedKinds.test_build_persist_load": ("kind",
                                                         ("ivfsq", "hnsw"))}


def expand(files):
    """(case, parameters) of each reference case, one a parameter
    value."""
    out = []
    for name in files:
        for case in reference_cases(name, classes=True):
            if case[1] in PARAMS:
                p, values = PARAMS[case[1]]
                out += [(case, {p: v}) for v in values]
            else:
                out.append((case, {}))
    return out


def case_ids(cases):
    return [c[1] + "".join(f"[{v}]" for v in p.values()) for c, p in cases]


class WithParams:
    """pytest's `request` with a case's parameters as fixtures."""

    def __init__(self, request, params):
        self.request = request
        self.params = params

    def getfixturevalue(self, name):
        if name in self.params:
            return self.params[name]
        return self.request.getfixturevalue(name)


def search_on_cpu(monkeypatch):
    """The port's indexes built with device=None train on the CPU for
    one test, and a reference case importing tests.test_ivfpq gets the
    port's version of it."""
    monkeypatch.setattr(ann, "resolve_device", lambda device=None:
                        resolve_device("cpu" if device is None else device))
    monkeypatch.setitem(sys.modules, "tests.test_ivfpq",
                        reference_module("test_ivfpq", True))


def run_search_case(case, params, pkg, tmp_path, monkeypatch, request):
    if pkg == "port":
        search_on_cpu(monkeypatch)
    run_reference_case(case, pkg, tmp_path, monkeypatch,
                       WithParams(request, params))


CASES = expand(["test_vector_search", "test_ivfpq", "test_ann_sq_hnsw"])


def test_reference_cases_are_all_listed():
    assert len(CASES) == 7 + 9 + 12


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_search_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- the exactness rule -------------------------------------------------------

def tau(scores):
    return 1e-5 * np.maximum(1.0, np.abs(scores))


def assert_topk_agree(ref_scores, ref_ids, got_scores, got_ids):
    """The exactness rule on [Q, k] results (module docstring)."""
    ref_scores = np.asarray(ref_scores, np.float64)
    got_scores = np.asarray(got_scores, np.float64)
    assert got_scores.shape == ref_scores.shape == got_ids.shape
    assert np.all(np.abs(got_scores - ref_scores) <= tau(ref_scores))
    k = ref_ids.shape[1]
    for s, want, got in zip(ref_scores, ref_ids, got_ids):
        start = 0
        for j in range(k):
            if j + 1 < k and abs(s[j] - s[j + 1]) <= tau(s[j]):
                continue                      # the run goes on
            run = slice(start, j + 1)
            missing = set(want[run].tolist()) - set(got[run].tolist())
            if j + 1 < k:
                assert not missing, (want, got)
            else:
                assert len(missing) <= 1, (want, got)
            start = j + 1


def assert_codes_agree(vectors, codebooks, ref_codes, got_codes):
    """Codes equal except where a vector's two nearest codewords are a
    near-tie (their reference distances within tau)."""
    diff = np.argwhere(ref_codes != got_codes)
    for n, m in diff:
        sub = vectors[m, n]
        d = np.sum((codebooks[m] - sub) ** 2, axis=1)
        a, b = d[ref_codes[n, m]], d[got_codes[n, m]]
        assert abs(a - b) <= tau(a), (n, m, a, b)


def _t(a):
    return torch.from_numpy(np.array(a))


def _corpus(seed, n, d, q):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    return c, rng.standard_normal((q, d)).astype(np.float32)


# -- the four device programs -------------------------------------------------

@pytest.mark.parametrize("shape", [(2000, 32, 40, 10), (513, 7, 3, 1)],
                         ids=["2000x32", "513x7"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_topk_scores_agree_with_reference(metric, shape):
    n, d, q, k = shape
    corpus, queries = _corpus(1, n, d, q)
    csq = np.sum(corpus * corpus, axis=1)
    rs, ri = ref_ann._topk_scores(queries, corpus, csq, k, metric)
    gs, gi = ann._topk_scores(_t(queries), _t(corpus), _t(csq), k, metric)
    assert_topk_agree(np.asarray(rs), np.asarray(ri), gs.numpy(),
                      gi.numpy())


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_topk_ties_go_to_the_lower_index(metric):
    """Exact ties (repeated corpus rows, and dot products of +0.0 and
    -0.0) rank lower index first, as jax.lax.top_k ranks them: ids and
    scores equal the reference's position by position."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((40, 8)).astype(np.float32)
    corpus = base[rng.integers(0, 40, 400)]      # every row ~10 times
    queries = np.concatenate([base[:6], np.zeros((1, 8), np.float32)])
    if metric == "dot":
        corpus[::7] = 0.0
        corpus[3::7] = -0.0
    csq = np.sum(corpus * corpus, axis=1)
    rs, ri = ref_ann._topk_scores(queries, corpus, csq, 25, metric)
    gs, gi = ann._topk_scores(_t(queries), _t(corpus), _t(csq), 25,
                              metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert np.all(np.abs(gs.numpy() - np.asarray(rs))
                  <= tau(np.asarray(rs)))


def test_topk_score_blocks_give_one_block_result(monkeypatch):
    """Chunking the queries so one block of scores stays under
    SCORE_BLOCK_BYTES gives the one-block result under the exactness
    rule (a product of fewer rows may sum in another order)."""
    corpus, queries = _corpus(2, 1000, 16, 37)
    csq = _t(np.sum(corpus * corpus, axis=1))
    whole = ann._topk_scores(_t(queries), _t(corpus), csq, 5, "l2")
    monkeypatch.setattr(ann, "SCORE_BLOCK_BYTES", 8 * 1000 * 3)
    blocks = ann._topk_scores(_t(queries), _t(corpus), csq, 5, "l2")
    assert_topk_agree(whole[0].numpy(), whole[1].numpy(),
                      blocks[0].numpy(), blocks[1].numpy())


def test_kmeans_agrees_with_reference():
    """From the same initial centroids, on the reference's test inputs:
    centroids within 1e-4 of the data's scale, assignments equal."""
    v, rng = clustered(6000, 32)
    init = v[rng.choice(len(v), 64, replace=False)]
    want = np.asarray(ref_ann._kmeans(v, init, 8))
    got = ann._kmeans(_t(v), _t(init), 8).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(v).max()
    np.testing.assert_array_equal(
        ann._assign(_t(v), _t(got)).numpy(),
        np.argmin(np.sum(v ** 2, 1, keepdims=True)
                  + np.sum(want ** 2, 1)[None, :] - 2.0 * v @ want.T, 1))


def test_kmeans_empty_cluster_keeps_its_centroid():
    v, _ = clustered(500, 8)
    init = np.concatenate([v[:7], np.full((1, 8), 1e3, np.float32)])
    got = ann._kmeans(_t(v), _t(init), 4).numpy()
    want = np.asarray(ref_ann._kmeans(v, init, 4))
    np.testing.assert_array_equal(got[7], init[7])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(v).max()


def test_assign_blocks_give_one_block_result(monkeypatch):
    v, _ = clustered(3000, 16)
    c = _t(v[:50])
    whole = ann._assign(_t(v), c)
    monkeypatch.setattr(ann, "SCORE_BLOCK_BYTES", 4 * 50 * 7)
    assert torch.equal(ann._assign(_t(v), c), whole)


def _subspaces(seed, n, m, dsub, ksub):
    v, rng = clustered(n, m * dsub, seed=seed)
    sub = np.ascontiguousarray(v.reshape(n, m, dsub).transpose(1, 0, 2))
    init = np.stack([s[rng.choice(n, ksub, replace=False)] for s in sub])
    return sub, init


def test_kmeans_batch_agrees_with_reference():
    sub, init = _subspaces(3, 4000, 8, 4, 64)
    want = np.asarray(ref_ann._kmeans_batch(sub, init, 8))
    got = ann._kmeans_batch(_t(sub), _t(init), 8).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(sub).max()
    # each subspace alone is _kmeans
    for j in range(len(sub)):
        one = ann._kmeans(_t(sub[j]), _t(init[j]), 8).numpy()
        assert np.abs(one - got[j]).max() <= 1e-4 * np.abs(sub).max()


def test_pq_encode_agrees_with_reference(monkeypatch):
    sub, init = _subspaces(4, 3000, 8, 4, 256)
    cb = np.asarray(ref_ann._kmeans_batch(sub, init, 4))
    want = np.asarray(ref_ann._pq_encode(sub, cb))
    got = ann._pq_encode(_t(sub), _t(cb)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (3000, 8)
    assert_codes_agree(sub, cb, want, got)
    monkeypatch.setattr(ann, "SCORE_BLOCK_BYTES", 4 * 8 * 256 * 5)
    np.testing.assert_array_equal(
        ann._pq_encode(_t(sub), _t(cb)).numpy(), got)


# -- index states across the packages -----------------------------------------

KINDS = {
    "ivfpq": lambda mod, v: mod.IVFPQIndex(v, m=8, metric="l2", seed=3,
                                           **_cpu(mod)),
    "ivfpq-cosine": lambda mod, v: mod.IVFPQIndex(
        v, m=4, metric="cosine", seed=3, **_cpu(mod)),
    "ivfsq": lambda mod, v: mod.IVFSQIndex(v, metric="l2", seed=3,
                                           **_cpu(mod)),
    "ivfsq-dot": lambda mod, v: mod.IVFSQIndex(v, metric="dot", seed=3,
                                               **_cpu(mod)),
    "ivfsq-cosine": lambda mod, v: mod.IVFSQIndex(v, metric="cosine",
                                                  seed=3, **_cpu(mod)),
    "hnsw": lambda mod, v: mod.HNSWIndex(v[:600], m=8, metric="l2", seed=3),
}


def _cpu(mod):
    return {"device": "cpu"} if mod is ann else {}


def _search(idx, kind, q, v):
    if kind == "hnsw":
        return idx.search(q, 10, ef=40)
    return idx.search(q, 10, nprobe=6, refine=50, vectors=v)


@pytest.mark.parametrize("builder", ["reference", "port"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_index_states_cross_load_and_search_alike(kind, builder):
    """A state built by one package loads in the other; both search it
    bit for bit alike (approximate search, refine and HNSW are host code
    in both)."""
    v, rng = clustered(3000, 32, seed=7)
    q = v[rng.choice(len(v), 20, replace=False)] \
        + 0.05 * rng.normal(size=(20, 32)).astype(np.float32)
    src, dst = (ref_ann, ann) if builder == "reference" else (ann, ref_ann)
    built = KINDS[kind](src, v)
    meta, arrays = built.state()
    cls = kind.split("-")[0]
    loaded = {"ivfpq": dst.IVFPQIndex, "ivfsq": dst.IVFSQIndex,
              "hnsw": dst.HNSWIndex}[cls].from_state(meta, arrays)
    again = type(built).from_state(meta, arrays)
    for a, b in zip(_search(again, kind, q, v), _search(loaded, kind, q, v)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["ivfpq", "ivfsq"])
def test_port_builds_reach_the_reference_recall(kind):
    """The port's trained index finds what the reference's finds (within
    two hits in 200) on the same seeded build."""
    v, rng = clustered(4000, 32, seed=9)
    q = v[rng.choice(len(v), 20, replace=False)] \
        + 0.01 * rng.normal(size=(20, 32)).astype(np.float32)
    exact = np.argsort(((v[None] - q[:, None]) ** 2).sum(-1), axis=1)[:, :10]
    got = {}
    for mod in (ref_ann, ann):
        idx = KINDS[kind](mod, v)
        got[mod] = recall_at_k(idx.search(q, 10, nprobe=8)[1], exact, 10)
    assert got[ann] >= got[ref_ann] - 0.01, got


def test_ivf_flat_host_search_is_the_reference_on_a_shared_state():
    """IVF-Flat's probe and cluster scan are the reference's host code:
    on one coarse layout both packages answer bit for bit alike; the
    layout from given assignments is the reference's."""
    v, rng = clustered(3000, 24, seed=2)
    q = rng.normal(size=(15, 24)).astype(np.float32)
    port = ann.IVFFlatIndex(v, n_clusters=20, metric="cosine", device="cpu")
    ref = ref_ann.IVFFlatIndex.__new__(ref_ann.IVFFlatIndex)
    ref.__dict__.update(port.__dict__)
    for a, b in zip(port.search(q, 10, nprobe=5), ref.search(q, 10,
                                                             nprobe=5)):
        np.testing.assert_array_equal(a, b)
    assign = ann._assign(_t(v), _t(port.centroids)).numpy()
    order = np.argsort(assign, kind="stable")
    members, bounds = ann._layout(assign, 20)
    np.testing.assert_array_equal(members, order.astype(np.int32))
    np.testing.assert_array_equal(
        bounds, np.searchsorted(assign[order], np.arange(21)))
    np.testing.assert_array_equal(port._members, order)


# -- persisted indexes across the packages ------------------------------------

def _vec_table(pkg, path, v):
    if pkg == "port":
        b = Schema.builder().column("id", BigIntType(False)) \
            .column("emb", ArrayType(FloatType()))
        make = lambda s: FileStoreTable.create(path, s, device="cpu")  # noqa
    else:
        b = RefSchema.builder().column("id", RefBigInt(False)) \
            .column("emb", RefArray(RefFloat()))
        make = lambda s: RefTable.create(path, s)  # noqa
    t = make(b.options({"bucket": "-1"}).build())
    _append(t, v, 0)
    return t


def _append(t, v, first_id):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(pa.table({
        "id": pa.array(range(first_id, first_id + len(v)), pa.int64()),
        "emb": pa.array(v.tolist(), pa.list_(pa.float32()))}))
    wb.new_commit().commit(w.prepare_commit())
    w.close()


def _load(pkg, path):
    return FileStoreTable.load(path, device="cpu") if pkg == "port" \
        else RefTable.load(path)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("kind", ["ivfpq", "ivfsq", "hnsw"])
def test_persisted_indexes_cross_load(tmp_path, kind, writer):
    """Each package's PersistedVectorIndex loads the other's files and
    searches them alike; a commit after the build makes both stale."""
    v, _ = clustered(1500, 16, seed=4)
    path = str(tmp_path / "vecs")
    t = _vec_table(writer, path, v)
    mod = ann if writer == "port" else ref_ann
    mod.PersistedVectorIndex(t, "emb").build(kind=kind, m=4, metric="l2")
    reader = "reference" if writer == "port" else "port"
    loaded = {p: (ann if p == "port" else ref_ann).PersistedVectorIndex(
        _load(p, path), "emb").load() for p in ("port", "reference")}
    assert type(loaded["port"]).__name__ == \
        type(loaded["reference"]).__name__
    kw = {"ef": 40} if kind == "hnsw" else {"nprobe": 8}
    for a, b in zip(loaded["port"].search(v[:10], 5, **kw),
                    loaded["reference"].search(v[:10], 5, **kw)):
        np.testing.assert_array_equal(a, b)
    _append(_load(reader, path), v[:3], len(v))
    for p in ("port", "reference"):
        assert (ann if p == "port" else ref_ann).PersistedVectorIndex(
            _load(p, path), "emb").load() is None


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_vector_search_rows_equal_reference(tmp_path, metric):
    """vector_search over one table: the same rows in the same order,
    `_score` within tau, a batch of queries with its `_query` column,
    and one query without it."""
    v, rng = clustered(800, 16, seed=6)
    path = str(tmp_path / "vecs")
    _vec_table("reference", path, v)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    got = ann.vector_search(_load("port", path), "emb", q, k=7,
                            metric=metric)
    want = ref_ann.vector_search(_load("reference", path), "emb", q, k=7,
                                 metric=metric)
    assert got.column_names == want.column_names
    assert got.drop_columns(["_score"]).equals(
        want.drop_columns(["_score"]))
    ws = np.asarray(want.column("_score"))
    assert np.all(np.abs(np.asarray(got.column("_score")) - ws) <= tau(ws))
    one = ann.vector_search(_load("port", path), "emb", q[1], k=3,
                            metric=metric)
    ref = ref_ann.vector_search(_load("reference", path), "emb", q[1], k=3,
                                metric=metric)
    assert one.drop_columns(["_score"]).equals(ref.drop_columns(["_score"]))


# -- full float32 -------------------------------------------------------------

def test_float32_products_stay_full_precision():
    """The port neither turns TF32 on nor lowers float32 matmul
    precision: rankings stay the reference's."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(os.path.dirname(here), "paimon_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                for word in ("allow_tf32", "set_float32_matmul_precision",
                             "fp32_precision"):
                    assert word not in src, (f, word)
    v, _ = clustered(300, 8)
    ann.BruteForceIndex(v, "l2", device="cpu").search(v[:3], 5)
    ann.IVFPQIndex(v, m=4, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
