"""Hybrid search: fuse vector and full-text routes into one ranked
result.

reference: globalindex/HybridSearchRanker.java:32 (rrf /
weighted_score / mrr fusers, RRF_K=60, per-route min-max normalization
for weighted_score, rank ties by ascending row id, top-k ties keep the
smaller row id), table/source/HybridSearchBuilder.java (addVectorRoute
/ addFullTextRoute with per-route limit + weight),
table/HybridSearchTable.java.

Fusion runs vectorized: per route the rank order is one lexsort and
contributions accumulate with np.add.at over the union of row ids.

Counterpart of paimon_tpu/vector/hybrid.py: the fusion is the
reference's host numpy, bit for bit; a vector route's brute-force index
and the table read run on the table's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

__all__ = ["rank_hybrid", "hybrid_search", "RRF_K", "RANKERS"]

RRF_K = 60.0
RANKERS = ("rrf", "weighted_score", "mrr")


def _normalize_ranker(ranker: Optional[str]) -> str:
    if not ranker or not ranker.strip():
        return "rrf"
    r = ranker.strip().lower()
    if r not in RANKERS:
        raise ValueError(f"Unsupported hybrid ranker: {ranker}")
    return r


def _ranked_order(ids: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Positions sorted by score desc, ties by ascending row id
    (reference rankedRowIds)."""
    return np.lexsort((ids, -scores.astype(np.float64)))


def rank_hybrid(routes: Sequence[Tuple[np.ndarray, np.ndarray, float]],
                ranker: str = "rrf", limit: int = 10
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse per-route (row_ids, scores, weight) into (row_ids, fused)
    sorted by fused score desc (ties: smaller row id first), capped at
    `limit`."""
    ranker = _normalize_ranker(ranker)
    all_ids: List[np.ndarray] = []
    all_contrib: List[np.ndarray] = []
    for ids, scores, weight in routes:
        ids = np.asarray(ids, dtype=np.int64)
        scores = np.asarray(scores, dtype=np.float32)
        if len(ids) == 0:
            continue
        if ranker in ("rrf", "mrr"):
            order = _ranked_order(ids, scores)
            rank = np.empty(len(ids), dtype=np.float64)
            rank[order] = np.arange(len(ids))
            denom = (RRF_K + rank + 1.0) if ranker == "rrf" \
                else (rank + 1.0)
            contrib = weight / denom
        else:                        # weighted_score: min-max per route
            lo = float(scores.min())
            hi = float(scores.max())
            rng = hi - lo
            # no spread carries no relative signal: every hit maps to
            # 1.0 rather than being zeroed out (reference comment)
            norm = (scores - lo) / rng if rng > 0 \
                else np.ones_like(scores, dtype=np.float64)
            contrib = weight * norm.astype(np.float64)
        all_ids.append(ids)
        all_contrib.append(np.asarray(contrib, dtype=np.float64))

    if not all_ids or limit <= 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.float32))
    ids_cat = np.concatenate(all_ids)
    contrib_cat = np.concatenate(all_contrib)
    uniq, inverse = np.unique(ids_cat, return_inverse=True)
    fused = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(fused, inverse, contrib_cat)
    order = np.lexsort((uniq, -fused))[:limit]
    return uniq[order], fused[order].astype(np.float32)


def hybrid_search(table, routes: Sequence[dict], k: int = 10,
                  ranker: str = "rrf") -> pa.Table:
    """Multi-route search over one table.  Each route is a dict:
      {"type": "vector", "column": c, "query": vec,
       "limit": n, "weight": w, "metric": "cosine"}
      {"type": "text",   "column": c, "query": "terms",
       "limit": n, "weight": w}
    A route may carry a prebuilt "index" (BruteForceIndex /
    IVFFlatIndex / FullTextIndex) so repeated queries amortize index
    construction, mirroring vector_search/full_text_search's index=.
    Returns the fused top-k rows with a `_score` column (reference
    HybridSearchTable read path)."""
    from paimon_tpu_torch.index.fulltext import FullTextIndex
    from paimon_tpu_torch.vector.ann import BruteForceIndex, _as_matrix

    ranker = _normalize_ranker(ranker)   # fail fast, before any index

    # persisted text indexes score by _ROW_ID, not position: when any
    # text route will read one, fetch row ids in the SAME table read so
    # positions and ids stay aligned
    persisted: dict = {}
    for r in routes:
        if r.get("type") == "text" and r.get("index") is None:
            col = r["column"]
            if col not in persisted:
                from paimon_tpu_torch.index.fulltext import \
                    PersistedFullTextIndex as _P
                p = _P.open(table, col)
                persisted[col] = p if p.meta is not None else None
    want_ids = any(v is not None for v in persisted.values())
    data = table.to_arrow(with_row_ids=True) if want_ids \
        else table.to_arrow()
    rowid_pos: Optional[dict] = None

    def _positions_of(row_ids: np.ndarray) -> np.ndarray:
        nonlocal rowid_pos
        if rowid_pos is None:
            from paimon_tpu_torch.core.row_tracking import ROW_ID_COL
            rids = np.asarray(data.column(ROW_ID_COL).combine_chunks()
                              .cast(pa.int64()))
            rowid_pos = {int(r): i for i, r in enumerate(rids)}
        return np.array([rowid_pos.get(int(r), -1) for r in row_ids],
                        dtype=np.int64)

    fused_routes = []
    for r in routes:
        kind = r.get("type")
        col = r["column"]
        route_limit = int(r.get("limit", k))
        weight = float(r.get("weight", 1.0))
        if kind == "vector":
            idx = r.get("index") or BruteForceIndex(
                _as_matrix(data.column(col)), r.get("metric", "cosine"),
                device=table.device)
            q = np.asarray(r["query"], dtype=np.float32)
            scores, ids = idx.search(q, route_limit)
            valid = ids[0] >= 0
            fused_routes.append((ids[0][valid].astype(np.int64),
                                 scores[0][valid], weight))
        elif kind == "text":
            idx = r.get("index")
            if idx is None and persisted.get(col) is not None:
                # the persisted BM25 index: O(matched postings)
                # instead of re-tokenizing the whole corpus per query
                rids, scores = persisted[col].search(r["query"],
                                                     route_limit)
                pos = _positions_of(rids)
                live = pos >= 0          # deleted rows drop out here
                fused_routes.append((pos[live], scores[live], weight))
                continue
            if idx is None:
                idx = FullTextIndex(data.column(col).to_pylist())
            ids, scores = idx.search(r["query"], route_limit)
            fused_routes.append((ids, scores, weight))
        else:
            raise ValueError(f"Unknown hybrid route type {kind!r}")

    row_ids, fused = rank_hybrid(fused_routes, ranker=ranker, limit=k)
    out = data.take(pa.array(row_ids))
    if want_ids:
        from paimon_tpu_torch.core.row_tracking import ROW_ID_COL
        if ROW_ID_COL in out.column_names:
            out = out.drop_columns([ROW_ID_COL])
    return out.append_column("_score", pa.array(fused, pa.float32()))
