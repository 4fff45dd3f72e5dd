"""Full-text search index: BM25, persisted postings, incremental build.

reference capability: paimon-full-text (native tantivy-like inverted
indexer behind NativeFullTextGlobalIndexer.java) + paimon-eslib (Lucene
analyzers, ESIndexGlobalIndexerFactory.java:32, ESIndexOptions.java:28).

TPU-first shape: postings are columnar arrays scored in one vectorized
pass per query term (no per-doc scoring loop), and the persisted layout
is Parquet segments under the table's index directory —
`{table}/index/fulltext/{column}/seg-*.parquet` sorted by term with
small row groups, so a term query decodes only the row groups whose
[min,max] term range covers it (O(matched postings), not O(corpus)).
Segments are immutable; an incremental refresh indexes only rows whose
`_ROW_ID` is beyond the last indexed id and appends one new segment
(`optimize()` folds them back into one).

Counterpart of paimon_tpu/index/fulltext.py, host code as the
reference's: the analyzer, BM25 and the segment layout are the
reference's, so either package refreshes, optimizes and searches the
other's segments; the table reads it makes run on the table's device.
Both indexes tokenize ASCII text under the default analyzer with one
translate and an Arrow split (the same tokens as the reference's scan of
each character, which only CJK text needs) and gather their postings
with numpy sorts (`_Postings`) where the reference appends to a dict of
lists token by token: the same postings, segments byte for byte.  A
persisted search keeps each term's positions as one array (`_Positions`)
until a phrase reads them.
"""

from __future__ import annotations

import io
import json
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

__all__ = ["Analyzer", "FullTextIndex", "PersistedFullTextIndex",
           "full_text_search", "tokenize"]

_WORD = re.compile(r"\w+", re.UNICODE)

# BM25 constants (the standard Robertson defaults, same as Lucene's
# BM25Similarity)
K1 = 1.2
B = 0.75

_SUFFIXES = ("ational", "iveness", "fulness", "ousness", "ization",
             "sses", "ments", "ingly", "ation", "ness", "ment", "ies",
             "ing", "ed", "es", "s")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x3040 <= cp <= 0x30FF or 0xAC00 <= cp <= 0xD7AF)


class Analyzer:
    """Configurable tokenizer: lowercase folding, optional light
    suffix-stripping stemmer, CJK-safe segmentation (contiguous CJK
    runs emit overlapping bigrams — the Lucene CJKAnalyzer approach —
    since CJK text has no word delimiters)."""

    def __init__(self, lowercase: bool = True, stem: bool = False,
                 min_token_len: int = 1,
                 stopwords: Optional[Sequence[str]] = None):
        self.lowercase = lowercase
        self.stem = stem
        self.min_token_len = min_token_len
        self.stopwords = frozenset(stopwords or ())

    # -- config (persisted in meta.json so queries re-analyze
    #    identically across processes) --------------------------------
    def to_json(self) -> dict:
        return {"lowercase": self.lowercase, "stem": self.stem,
                "min_token_len": self.min_token_len,
                "stopwords": sorted(self.stopwords)}

    @classmethod
    def from_json(cls, j: dict) -> "Analyzer":
        return cls(lowercase=j.get("lowercase", True),
                   stem=j.get("stem", False),
                   min_token_len=j.get("min_token_len", 1),
                   stopwords=j.get("stopwords") or None)

    def _stem(self, tok: str) -> str:
        for suf in _SUFFIXES:
            if tok.endswith(suf) and len(tok) - len(suf) >= 3:
                return tok[: len(tok) - len(suf)]
        return tok

    def tokens(self, text: str) -> List[str]:
        if not text:
            return []
        if self.lowercase:
            text = text.lower()
        out: List[str] = []
        for m in _WORD.finditer(text):
            w = m.group(0)
            # split the word into non-CJK spans and CJK bigram runs
            i, n = 0, len(w)
            while i < n:
                if _is_cjk(w[i]):
                    j = i
                    while j < n and _is_cjk(w[j]):
                        j += 1
                    run = w[i:j]
                    if len(run) == 1:
                        out.append(run)
                    else:
                        out.extend(run[p:p + 2]
                                   for p in range(len(run) - 1))
                    i = j
                else:
                    j = i
                    while j < n and not _is_cjk(w[j]):
                        j += 1
                    tok = w[i:j]
                    if len(tok) >= self.min_token_len and \
                            tok not in self.stopwords:
                        out.append(self._stem(tok) if self.stem else tok)
                    i = j
        return out


_DEFAULT = Analyzer()


def tokenize(text: str) -> List[str]:
    return _DEFAULT.tokens(text)


def _parse_query(query: str) -> Tuple[List[str], str]:
    """'a b' -> (terms, 'or'); '+a +b' / 'a AND b' -> 'and';
    '"a b"' -> phrase."""
    q = query.strip()
    if len(q) >= 2 and q[0] == '"' and q[-1] == '"':
        return q[1:-1].split(), "phrase"
    if " AND " in q:
        return [t for t in q.split() if t != "AND"], "and"
    if any(t.startswith("+") for t in q.split()):
        return [t.lstrip("+") for t in q.split()], "and"
    return q.split(), "or"


def _bm25(tf: np.ndarray, df: int, n_docs: int, dl: np.ndarray,
          avgdl: float) -> np.ndarray:
    idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    denom = tf + K1 * (1.0 - B + B * dl / max(avgdl, 1e-9))
    return (idf * tf * (K1 + 1.0) / denom).astype(np.float32)


class _Scorer:
    """Shared BM25 + AND/phrase machinery over per-term postings:
    `fetch(term) -> (doc_ids, tf, positions_list_or_None)`."""

    def __init__(self, n_docs: int, avgdl: float, doc_len_of):
        self.n_docs = n_docs
        self.avgdl = avgdl
        self.doc_len_of = doc_len_of      # (doc_ids) -> lengths

    def score(self, postings: List[Tuple[np.ndarray, np.ndarray,
                                         Optional[list]]],
              mode: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        live = [(ids, tf, pos) for ids, tf, pos in postings
                if len(ids) > 0]
        if not live or (mode in ("and", "phrase")
                        and len(live) != len(postings)):
            return (np.zeros(0, np.int64), np.zeros(0, np.float32))
        ids_cat = np.concatenate([p[0] for p in live])
        contribs = []
        for ids, tf, _ in live:
            dl = self.doc_len_of(ids)
            contribs.append(_bm25(tf.astype(np.float64), len(ids),
                                  self.n_docs, dl, self.avgdl))
        contrib_cat = np.concatenate(contribs)
        uniq, inverse = np.unique(ids_cat, return_inverse=True)
        scores = np.zeros(len(uniq), dtype=np.float64)
        np.add.at(scores, inverse, contrib_cat)
        if mode in ("and", "phrase"):
            hits = np.zeros(len(uniq), dtype=np.int32)
            np.add.at(hits, inverse, 1)
            keep = hits == len(live)
            if mode == "phrase":
                keep &= self._phrase_ok(uniq, live)
            uniq, scores = uniq[keep], scores[keep]
        if len(uniq) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32))
        order = np.lexsort((uniq, -scores))[:k]
        return uniq[order].astype(np.int64), \
            scores[order].astype(np.float32)

    def _phrase_ok(self, docs: np.ndarray,
                   live: List[Tuple]) -> np.ndarray:
        """docs that contain the terms at consecutive positions."""
        pos_maps = []
        for ids, _, pos_list in live:
            if pos_list is None:
                # positions unavailable: degrade to AND semantics
                return np.ones(len(docs), dtype=bool)
            pos_maps.append({int(d): pos_list[i]
                             for i, d in enumerate(ids)})
        ok = np.zeros(len(docs), dtype=bool)
        for i, d in enumerate(docs):
            d = int(d)
            if any(d not in m for m in pos_maps):
                continue
            cand = set(int(p) for p in pos_maps[0][d])
            for t in range(1, len(pos_maps)):
                nxt = set(int(p) - t for p in pos_maps[t][d])
                cand &= nxt
                if not cand:
                    break
            ok[i] = bool(cand)
        return ok


# every ASCII character that \w does not match, as a space
_NON_WORD = str.maketrans({chr(c): " " for c in range(128)
                           if not (chr(c).isalnum() or chr(c) == "_")})


def _token_lists(analyzer: Analyzer, texts: List[Optional[str]]):
    """Each text's tokens as one Arrow list (null for none).  Where the
    analyzer keeps every word as it is, an ASCII text's words are its
    runs of word characters: the rest become spaces and Arrow splits
    there; any other text's tokens come from Analyzer.tokens (a token
    holds no space)."""
    import pyarrow.compute as pc
    plain = not analyzer.stem and analyzer.min_token_len <= 1 and \
        not analyzer.stopwords
    joined = []
    for t in texts:
        if t and plain and t.isascii():
            t = (t.lower() if analyzer.lowercase else t) \
                .translate(_NON_WORD).strip()
        elif t:
            t = " ".join(analyzer.tokens(t))
        joined.append(t or None)
    return pc.utf8_split_whitespace(pa.array(joined, pa.string()))


class _Postings:
    """Every (term, doc) pair of a list of texts: terms numbered in order
    of first occurrence, pairs ordered by term number then doc, each
    pair's positions ascending in `pos[offs[j]:offs[j + 1]]`."""

    def __init__(self, analyzer: Analyzer, texts: List[Optional[str]]):
        import pyarrow.compute as pc
        lists = _token_lists(analyzer, texts)
        self.doc_len = pc.list_value_length(lists).fill_null(0) \
            .to_numpy().astype(np.int64)
        # terms numbered in order of first occurrence, as a dict
        # inserting them would: Arrow's dictionary encoding
        codes = lists.flatten().dictionary_encode()
        term = codes.indices.to_numpy().astype(np.int64)
        self.terms = codes.dictionary.to_pylist()
        doc = np.repeat(np.arange(len(texts)), self.doc_len)
        pos = np.arange(len(term)) - np.repeat(
            np.cumsum(self.doc_len) - self.doc_len, self.doc_len)
        order = np.lexsort((doc, term))     # stable: positions ascend
        term, doc, self.pos = term[order], doc[order], pos[order]
        first = np.ones(len(term), dtype=bool)
        first[1:] = (term[1:] != term[:-1]) | (doc[1:] != doc[:-1])
        starts = np.flatnonzero(first)
        self.term, self.doc = term[starts], doc[starts]
        self.offs = np.append(starts, len(term))
        self.tf = np.diff(self.offs)
        # the pairs of term number t: bounds[t]:bounds[t + 1]
        self.bounds = np.searchsorted(self.term, np.arange(len(self.terms)
                                                           + 1))


class _Positions:
    """One term's positions in each of its docs, as views of one array
    (what the reference keeps as a list of lists)."""

    __slots__ = ("pos", "offs")

    def __init__(self, pos: np.ndarray, offs: np.ndarray):
        self.pos, self.offs = pos, offs

    def __len__(self) -> int:
        return len(self.offs) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.pos[self.offs[i]:self.offs[i + 1]]

    def slice(self, a: int, b: int) -> "_Positions":
        return _Positions(self.pos, self.offs[a:b + 1])

    def take(self, order: np.ndarray) -> "_Positions":
        """The lists in `order`, gathered into one array."""
        lens = np.diff(self.offs)[order]
        offs = np.zeros(len(order) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        gather = np.repeat(self.offs[:-1][order] - offs[:-1], lens) + \
            np.arange(offs[-1])
        return _Positions(self.pos[gather], offs)

    @staticmethod
    def concat(parts: List["_Positions"]) -> "_Positions":
        pos = np.concatenate([p.pos[p.offs[0]:p.offs[-1]] for p in parts])
        lens = np.concatenate([np.diff(p.offs) for p in parts])
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        return _Positions(pos, offs)


class FullTextIndex:
    """In-memory inverted index over one text column (doc id = row
    position).  BM25 ranking; AND / phrase query modes."""

    def __init__(self, texts: List[Optional[str]],
                 analyzer: Optional[Analyzer] = None):
        self.analyzer = analyzer or _DEFAULT
        self.n = len(texts)
        p = _Postings(self.analyzer, texts)
        self.doc_len = p.doc_len.astype(np.float32)
        tf = p.tf.astype(np.float32)
        self.postings: Dict[str, Tuple[np.ndarray, np.ndarray,
                                       _Positions]] = {}
        for t, term in enumerate(p.terms):
            a, b = p.bounds[t], p.bounds[t + 1]
            self.postings[term] = (p.doc[a:b], tf[a:b],
                                   _Positions(p.pos, p.offs[a:b + 1]))
        self.avgdl = float(self.doc_len.sum() / max(self.n, 1))

    def _fetch(self, term: str):
        p = self.postings.get(term)
        if p is None:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32), [])
        return p

    def search(self, query: str, k: int = 10,
               mode: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (row_positions, scores) ranked best-first.  Query syntax:
        plain terms = OR; `a AND b` / `+a +b` = AND; `"a b"` = phrase."""
        terms, parsed_mode = _parse_query(query)
        mode = mode or parsed_mode
        terms = [t for ts in terms for t in self.analyzer.tokens(ts)]
        scorer = _Scorer(max(self.n, 1), self.avgdl,
                         lambda ids: self.doc_len[ids])
        return scorer.score([self._fetch(t) for t in terms], mode, k)


class PersistedFullTextIndex:
    """Segmented on-disk inverted index for row-tracked tables
    (doc id = `_ROW_ID`).  Survives process restart; `refresh()`
    incrementally indexes only rows beyond the last indexed row id.

    Layout under `{table}/index/fulltext/{column}/`:
      meta.json                  {version, column, snapshot_id,
                                  max_row_id, analyzer, segments: [...]}
      seg-<n>.parquet            (term, row_id, tf, positions)
                                 sorted by term, small row groups
      seg-<n>-docs.parquet       (row_id, doc_len) sorted by row_id
    """

    VERSION = 1
    ROW_GROUP = 4096

    def __init__(self, table, column: str,
                 analyzer: Optional[Analyzer] = None):
        self.table = table
        self.column = column
        self.analyzer = analyzer or Analyzer()
        self.meta: Optional[dict] = None
        self._doc_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    # -- storage ------------------------------------------------------
    @property
    def _dir(self) -> str:
        return f"{self.table.path}/index/fulltext/{self.column}"

    def _read(self, name: str) -> bytes:
        return self.table.file_io.read_bytes(f"{self._dir}/{name}")

    def _write(self, name: str, data: bytes) -> None:
        self.table.file_io.write_bytes(f"{self._dir}/{name}", data,
                                       overwrite=True)

    @classmethod
    def open(cls, table, column: str,
             analyzer: Optional[Analyzer] = None
             ) -> "PersistedFullTextIndex":
        idx = cls(table, column, analyzer)
        try:
            meta = json.loads(idx._read("meta.json"))
            if meta.get("version") == cls.VERSION and \
                    meta.get("column") == column:
                idx.meta = meta
                idx.analyzer = Analyzer.from_json(meta["analyzer"])
        except (FileNotFoundError, OSError, ValueError, KeyError):
            pass
        return idx

    # -- build --------------------------------------------------------
    def _rows_beyond(self, min_row_id_excl: int) -> pa.Table:
        from paimon_tpu_torch.core.row_tracking import ROW_ID_COL
        import pyarrow.compute as pc
        t = self.table.to_arrow(projection=[self.column],
                                with_row_ids=True)
        t = t.filter(pc.is_valid(t.column(ROW_ID_COL)))
        if min_row_id_excl >= 0:
            t = t.filter(pc.greater(t.column(ROW_ID_COL),
                                    min_row_id_excl))
        return t

    def _build_segment(self, texts: List[Optional[str]],
                       row_ids: np.ndarray, seg_name: str) -> dict:
        import pyarrow.parquet as pq
        p = _Postings(self.analyzer, texts)
        doc_len = p.doc_len.astype(np.int32)
        # rows by term (string order), then doc, as the reference's
        # sorted(postings) of lists appended doc by doc
        rank = np.empty(len(p.terms), np.int64)
        rank[sorted(range(len(p.terms)), key=p.terms.__getitem__)] = \
            np.arange(len(p.terms))
        order = np.lexsort((p.doc, rank[p.term]))
        pos = _Positions(p.pos, p.offs).take(order)
        seg = pa.table({
            "term": pa.array(np.array(p.terms, dtype=object)[p.term[order]]
                             if len(order) else [], pa.string()),
            "row_id": pa.array(np.asarray(row_ids, np.int64)[p.doc[order]],
                               pa.int64()),
            "tf": pa.array(p.tf[order], pa.int32()),
            "positions": pa.ListArray.from_arrays(
                pa.array(pos.offs, pa.int32()),
                pa.array(pos.pos, pa.int32())),
        })
        buf = io.BytesIO()
        pq.write_table(seg, buf, row_group_size=self.ROW_GROUP)
        self._write(f"{seg_name}.parquet", buf.getvalue())
        order = np.argsort(row_ids, kind="stable")
        dbuf = io.BytesIO()
        pq.write_table(pa.table({
            "row_id": pa.array(row_ids[order], pa.int64()),
            "doc_len": pa.array(doc_len[order], pa.int32()),
        }), dbuf)
        self._write(f"{seg_name}-docs.parquet", dbuf.getvalue())
        return {"file": f"{seg_name}.parquet",
                "docs_file": f"{seg_name}-docs.parquet",
                "num_docs": int(len(texts)),
                "sum_len": int(doc_len.sum()),
                "num_postings": int(len(order))}

    def refresh(self) -> int:
        """Index rows not yet covered; returns docs added.  Builds one
        new immutable segment (reference incremental indexer shape)."""
        latest = self.table.latest_snapshot()
        if latest is None:
            return 0
        if self.meta is not None and \
                self.meta["snapshot_id"] == latest.id:
            return 0
        max_rid = self.meta["max_row_id"] if self.meta else -1
        t = self._rows_beyond(max_rid)
        if t.num_rows == 0:
            if self.meta is not None:
                self.meta["snapshot_id"] = latest.id
                self._write("meta.json",
                            json.dumps(self.meta).encode())
            return 0
        from paimon_tpu_torch.core.row_tracking import ROW_ID_COL
        row_ids = np.asarray(t.column(ROW_ID_COL).combine_chunks()
                             .cast(pa.int64()))
        texts = t.column(self.column).to_pylist()
        seg_no = len(self.meta["segments"]) if self.meta else 0
        seg = self._build_segment(texts, row_ids,
                                  f"seg-{latest.id}-{seg_no}")
        if self.meta is None:
            self.meta = {"version": self.VERSION, "column": self.column,
                         "analyzer": self.analyzer.to_json(),
                         "segments": []}
        self.meta["segments"].append(seg)
        self.meta["snapshot_id"] = latest.id
        self.meta["max_row_id"] = int(max(max_rid, row_ids.max()))
        self._write("meta.json", json.dumps(self.meta).encode())
        self._doc_cache.clear()
        return t.num_rows

    def optimize(self) -> None:
        """Fold all segments into one (Lucene force-merge analog)."""
        import pyarrow.parquet as pq
        if not self.meta or len(self.meta["segments"]) <= 1:
            return
        segs = self.meta["segments"]
        posts = [pq.read_table(io.BytesIO(self._read(s["file"])))
                 for s in segs]
        docs = [pq.read_table(io.BytesIO(self._read(s["docs_file"])))
                for s in segs]
        post = pa.concat_tables(posts).sort_by([("term", "ascending"),
                                                ("row_id", "ascending")])
        doc = pa.concat_tables(docs).sort_by("row_id")
        buf = io.BytesIO()
        pq.write_table(post, buf, row_group_size=self.ROW_GROUP)
        name = f"seg-merged-{self.meta['snapshot_id']}"
        self._write(f"{name}.parquet", buf.getvalue())
        dbuf = io.BytesIO()
        pq.write_table(doc, dbuf)
        self._write(f"{name}-docs.parquet", dbuf.getvalue())
        self.meta["segments"] = [{
            "file": f"{name}.parquet",
            "docs_file": f"{name}-docs.parquet",
            "num_docs": int(sum(s["num_docs"] for s in segs)),
            "sum_len": int(sum(s["sum_len"] for s in segs)),
            "num_postings": int(post.num_rows)}]
        self._write("meta.json", json.dumps(self.meta).encode())
        self._doc_cache.clear()

    # -- query --------------------------------------------------------
    def _seg_postings(self, seg: dict, terms: List[str]
                      ) -> Dict[str, Tuple[np.ndarray, np.ndarray,
                                           list]]:
        """Read only the row groups whose term range intersects the
        query terms — O(matched postings + row-group overhead)."""
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(io.BytesIO(self._read(seg["file"])))
        tcol = pf.schema_arrow.get_field_index("term")
        want: List[int] = []
        for g in range(pf.num_row_groups):
            st = pf.metadata.row_group(g).column(tcol).statistics
            if st is None or st.min is None:
                want.append(g)
                continue
            if any(st.min <= t <= st.max for t in terms):
                want.append(g)
        out: Dict[str, Tuple[np.ndarray, np.ndarray, list]] = {}
        if not want:
            return out
        t = pf.read_row_groups(want)
        import pyarrow.compute as pc
        m = pc.is_in(t.column("term"), value_set=pa.array(terms))
        t = t.filter(m)
        if t.num_rows == 0:
            return out
        # each term's rows in file order, as the reference selects them;
        # their positions stay one array, read where a phrase asks
        codes = t.column("term").combine_chunks().dictionary_encode()
        order = np.argsort(codes.indices.to_numpy(), kind="stable")
        rid = np.asarray(t.column("row_id").combine_chunks())[order]
        tf = np.asarray(t.column("tf").combine_chunks()
                        .cast(pa.float32()))[order]
        positions = t.column("positions").combine_chunks()
        pos = _Positions(positions.values.to_numpy(),
                         positions.offsets.to_numpy()).take(order)
        ends = np.searchsorted(codes.indices.to_numpy()[order],
                               np.arange(len(codes.dictionary) + 1))
        for term, a, b in zip(codes.dictionary.to_pylist(), ends[:-1],
                              ends[1:]):
            out[term] = (rid[a:b], tf[a:b], pos.slice(a, b))
        return out

    def _doc_lens(self, seg: dict) -> Tuple[np.ndarray, np.ndarray]:
        key = seg["docs_file"]
        if key not in self._doc_cache:
            import pyarrow.parquet as pq
            t = pq.read_table(io.BytesIO(self._read(key)))
            self._doc_cache[key] = (
                np.asarray(t.column("row_id").combine_chunks()),
                np.asarray(t.column("doc_len").combine_chunks()
                           .cast(pa.float32())))
        return self._doc_cache[key]

    def search(self, query: str, k: int = 10,
               mode: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (row_ids, scores) best-first across all segments."""
        if not self.meta or not self.meta["segments"]:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32))
        terms, parsed_mode = _parse_query(query)
        mode = mode or parsed_mode
        terms = [t for ts in terms for t in self.analyzer.tokens(ts)]
        if not terms:
            return (np.zeros(0, np.int64), np.zeros(0, np.float32))
        segs = self.meta["segments"]
        n_docs = sum(s["num_docs"] for s in segs)
        avgdl = sum(s["sum_len"] for s in segs) / max(n_docs, 1)
        # gather per-term postings across segments (row-id spaces are
        # disjoint, so concatenation is a valid union)
        merged: Dict[str, List[Tuple]] = {t: [] for t in terms}
        dl_keys, dl_vals = [], []
        for seg in segs:
            found = self._seg_postings(seg, terms)
            for t, p in found.items():
                merged[t].append(p)
            ks, vs = self._doc_lens(seg)
            dl_keys.append(ks)
            dl_vals.append(vs)
        dlk = np.concatenate(dl_keys)
        dlv = np.concatenate(dl_vals)
        order = np.argsort(dlk, kind="stable")
        dlk, dlv = dlk[order], dlv[order]

        def doc_len_of(ids: np.ndarray) -> np.ndarray:
            pos = np.searchsorted(dlk, ids)
            pos = np.minimum(pos, max(len(dlk) - 1, 0))
            return dlv[pos] if len(dlk) else \
                np.zeros(len(ids), np.float32)

        postings = []
        for t in terms:
            parts = merged[t]
            if not parts:
                postings.append((np.zeros(0, np.int64),
                                 np.zeros(0, np.float32), []))
                continue
            ids = np.concatenate([p[0] for p in parts])
            tf = np.concatenate([p[1] for p in parts])
            pos = parts[0][2] if len(parts) == 1 else \
                _Positions.concat([p[2] for p in parts])
            postings.append((ids, tf, pos))
        scorer = _Scorer(max(n_docs, 1), avgdl, doc_len_of)
        return scorer.score(postings, mode, k)


def full_text_search(table, column: str, query: str, k: int = 10,
                     index: Optional[FullTextIndex] = None) -> pa.Table:
    """Search a table's text column; returns the top-k rows with a
    `_score` column (reference FullTextSearchTable /
    FullTextSearchSplit)."""
    data = table.to_arrow()
    idx = index or FullTextIndex(data.column(column).to_pylist())
    rows, scores = idx.search(query, k)
    out = data.take(pa.array(rows))
    return out.append_column("_score", pa.array(scores, pa.float32()))
