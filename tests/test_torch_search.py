"""Full-text and hybrid search of paimon_tpu_torch against paimon_tpu.

- The cases of tests/test_hybrid_search.py (8) and
  test_fulltext_persisted.py (20) run on both packages through
  tests/test_torch_vector.py's `run_search_case`, the port on the CPU.
- PersistedFullTextIndex segments written by one package are the other's
  byte for byte (one pyarrow writes both here), and each package
  refreshes, optimizes and searches the other's segments with equal
  results.
- `full_text_search`, `rank_hybrid` and `hybrid_search` (with a
  persisted text route read by `_ROW_ID`) return the reference's rows and
  `_score` columns: BM25 and the fusion are host code in both, so equal
  means equal; a vector route's scores come from the port's brute-force
  program, held within tau = 1e-5 * max(1, |s|).
"""

from __future__ import annotations

import io

import numpy as np
import pyarrow.parquet as pq
import pytest

import paimon_tpu.index.fulltext as ref_ft
import paimon_tpu.vector.hybrid as ref_hybrid
import paimon_tpu_torch.index.fulltext as ft
import paimon_tpu_torch.vector.hybrid as hybrid
from paimon_tpu.schema import Schema as RefSchema
from paimon_tpu.table import FileStoreTable as RefTable
from paimon_tpu.types import ArrayType as RefArray
from paimon_tpu.types import BigIntType as RefBigInt
from paimon_tpu.types import FloatType as RefFloat
from paimon_tpu.types import VarCharType as RefVarChar
from paimon_tpu_torch.schema import Schema
from paimon_tpu_torch.table import FileStoreTable
from paimon_tpu_torch.types import ArrayType, BigIntType, FloatType, VarCharType
from tests.test_torch_vector import expand, case_ids, run_search_case, tau

CASES = expand(["test_hybrid_search", "test_fulltext_persisted"])


def test_reference_cases_are_all_listed():
    assert len(CASES) == 8 + 20


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_search_case(case, params, pkg, tmp_path, monkeypatch, request)


# -- a seeded docs table on either package ------------------------------------

VOCAB = [f"w{i}" for i in range(300)]


def seeded_docs(seed, n, first_id=0):
    """n documents of 3-20 words from a Zipf-like vocabulary, a few with
    upper case and stemmable endings, and some empty."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    out = []
    for i in range(n):
        words = [VOCAB[j] for j in rng.choice(len(VOCAB),
                                              rng.integers(3, 21), p=p)]
        if i % 7 == 0:
            words += ["Running", "jumped", "cats"]
        out.append({"id": first_id + i,
                    "body": None if i % 23 == 5 else " ".join(words)})
    return out


class Side:
    """One package's table, full-text and hybrid API."""

    def __init__(self, name):
        self.name = name
        self.ft = ft if name == "port" else ref_ft
        self.hybrid = hybrid if name == "port" else ref_hybrid

    def create(self, path, vector=False):
        if self.name == "port":
            b = Schema.builder().column("id", BigIntType(False)) \
                .column("body", VarCharType.string_type())
            if vector:
                b = b.column("emb", ArrayType(FloatType()))
            return FileStoreTable.create(path, b.options(OPTIONS).build(),
                                         device="cpu")
        b = RefSchema.builder().column("id", RefBigInt(False)) \
            .column("body", RefVarChar.string_type())
        if vector:
            b = b.column("emb", RefArray(RefFloat()))
        return RefTable.create(path, b.options(OPTIONS).build())

    def load(self, path):
        return FileStoreTable.load(path, device="cpu") \
            if self.name == "port" else RefTable.load(path)

    def index(self, path, **kw):
        return self.ft.PersistedFullTextIndex.open(self.load(path), "body",
                                                   **kw)


OPTIONS = {"bucket": "-1", "row-tracking.enabled": "true"}
PORT, REF = Side("port"), Side("reference")


def write(table, rows):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_dicts(rows)
    wb.new_commit().commit(w.prepare_commit())
    w.close()


QUERIES = ["w3", "w1 w5 w40", "w2 AND w7", "+w1 +w9", '"w1 w2"',
           "running cats", "w299", "absent", "w0 w0 w1"]


def segment_files(path):
    idx = REF.index(path)
    out = {}
    for seg in idx.meta["segments"]:
        for f in (seg["file"], seg["docs_file"]):
            out[f] = idx._read(f)
    return out


# the package doing each step: build (open + refresh), the second
# refresh, optimize, the searches
STEPS = {"port-built": ("port", "reference", "port", "reference"),
         "reference-built": ("reference", "port", "reference", "port"),
         "port-optimized": ("reference", "reference", "port", "reference"),
         "reference-refreshed": ("port", "reference", "reference", "port")}


@pytest.mark.parametrize("steps", list(STEPS))
def test_segments_cross_refresh_optimize_and_search(tmp_path, steps):
    """The steps of one index alternate between the packages; at each
    step the segments equal those the reference alone writes, byte for
    byte, and every query answers as the reference's own index does."""
    build, refresh, optimize, search = (PORT if s == "port" else REF
                                        for s in STEPS[steps])
    path, alone = str(tmp_path / "mixed"), str(tmp_path / "alone")
    for p in (path, alone):
        write(REF.create(p), seeded_docs(1, 400))
    build.index(path, analyzer=build.ft.Analyzer(stem=True)).refresh()
    REF.index(alone, analyzer=ref_ft.Analyzer(stem=True)).refresh()
    for p in (path, alone):
        write(REF.load(p), seeded_docs(2, 150, first_id=1000))
        write(REF.load(p), seeded_docs(3, 90, first_id=2000))
    assert refresh.index(path).refresh() == 240
    assert REF.index(alone).refresh() == 240
    assert segment_files(path) == segment_files(alone)
    optimize.index(path).optimize()
    REF.index(alone).optimize()
    files = segment_files(path)
    assert files == segment_files(alone)
    assert len(files) == 2
    seg = pq.ParquetFile(io.BytesIO(next(
        v for f, v in files.items() if not f.endswith("-docs.parquet"))))
    assert seg.num_row_groups > 1
    got, want = search.index(path), REF.index(alone)
    for q in QUERIES:
        for a, b in zip(got.search(q, 15), want.search(q, 15)):
            np.testing.assert_array_equal(a, b)


def test_in_memory_index_equals_reference_and_persisted():
    """FullTextIndex (doc id = position) answers as the reference's."""
    rows = seeded_docs(4, 500)
    texts = [r["body"] for r in rows]
    got = ft.FullTextIndex(texts)
    want = ref_ft.FullTextIndex(texts)
    for q in QUERIES:
        for a, b in zip(got.search(q, 20), want.search(q, 20)):
            np.testing.assert_array_equal(a, b)
    assert ft.tokenize("Ünïcode 東京タワー runs") == \
        ref_ft.tokenize("Ünïcode 東京タワー runs")


@pytest.mark.parametrize("analyzer", [
    {}, {"lowercase": False}, {"stem": True},
    {"lowercase": False, "min_token_len": 3},
    {"stopwords": ["the", "a", "of"], "stem": True}])
def test_index_tokens_equal_reference(analyzer):
    """The tokens the port's indexes gather (an ASCII text translated
    and split by Arrow under the default analyzer, Analyzer.tokens
    otherwise) are the reference analyzer's: digits, underscores,
    punctuation, tabs, stopwords, stems, empty and CJK texts."""
    rng = np.random.default_rng(12)
    alphabet = list("abcdefgXYZ019_ .,;'-\t\n") + [
        "ing", "ation", "ness ", "the ", "A "]
    texts = ["".join(rng.choice(alphabet, rng.integers(0, 60)))
             for _ in range(300)]
    texts += ["東京タワー runs", "Jumping foxes ationally", "ÉCOLE école",
              None, "", " .,; "]
    got = ft._token_lists(ft.Analyzer(**analyzer), texts).to_pylist()
    want = ref_ft.Analyzer(**analyzer)
    for t, toks in zip(texts, got):
        assert (toks or []) == (want.tokens(t) if t else []), t


@pytest.mark.parametrize("query", QUERIES[:5])
def test_full_text_search_equals_reference(tmp_path, query):
    path = str(tmp_path / "docs")
    write(REF.create(path), seeded_docs(5, 300))
    got = ft.full_text_search(PORT.load(path), "body", query, k=12)
    want = ref_ft.full_text_search(REF.load(path), "body", query, k=12)
    assert got.equals(want)


@pytest.mark.parametrize("ranker", ["rrf", "weighted_score", "mrr"])
def test_rank_hybrid_equals_reference(ranker):
    rng = np.random.default_rng(8)
    routes = []
    for w in (1.0, 0.5, 2.0):
        ids = rng.choice(200, 60, replace=False)
        scores = np.round(rng.random(60), 2).astype(np.float32)  # ties
        routes.append((ids, scores, w))
    routes.append((np.arange(5), np.ones(5, np.float32), 1.0))  # flat
    for a, b in zip(hybrid.rank_hybrid(routes, ranker, 40),
                    ref_hybrid.rank_hybrid(routes, ranker, 40)):
        np.testing.assert_array_equal(a, b)


def _vector_docs(side, path, n=300, d=8):
    rng = np.random.default_rng(11)
    rows = seeded_docs(6, n)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    for r, e in zip(rows, emb):
        r["emb"] = e.tolist()
    write(side.create(path, vector=True), rows)
    return rng.normal(size=d).astype(np.float32)


@pytest.mark.parametrize("persisted", [True, False],
                         ids=["persisted-text", "in-memory-text"])
@pytest.mark.parametrize("ranker", ["rrf", "weighted_score", "mrr"])
def test_hybrid_search_equals_reference(tmp_path, ranker, persisted):
    """A vector and a text route fused by each ranker; the text route
    through the persisted index (read by _ROW_ID) or built in memory."""
    path = str(tmp_path / "docs")
    q = _vector_docs(REF, path)
    if persisted:
        REF.index(path).refresh()
        write(REF.load(path), [{"id": 5000, "body": "w1 w2 late",
                                "emb": [0.5] * 8}])    # not indexed yet
    routes = [{"type": "vector", "column": "emb", "query": q.tolist(),
               "limit": 20, "weight": 1.0, "metric": "l2"},
              {"type": "text", "column": "body", "query": "w1 w2 w17",
               "limit": 20, "weight": 0.7}]
    got = hybrid.hybrid_search(PORT.load(path), routes, k=15, ranker=ranker)
    want = ref_hybrid.hybrid_search(REF.load(path), routes, k=15,
                                    ranker=ranker)
    assert got.column_names == want.column_names
    assert "_ROW_ID" not in got.column_names
    assert got.drop_columns(["_score"]).equals(
        want.drop_columns(["_score"]))
    ws = np.asarray(want.column("_score"))
    assert np.all(np.abs(np.asarray(got.column("_score")) - ws) <= tau(ws))
