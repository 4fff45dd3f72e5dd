"""ANN indexes as matmul + top-k on the table's device.

Counterpart of paimon_tpu/vector/ann.py (reference capability:
paimon-vector's IVF-Flat / IVF-PQ factories behind
NativeVectorIndexLoader.java:28).  The similarity kernel is a matmul:
queries x corpus runs on the card in full float32 (cuBLAS; the port
never turns TF32 on) and `torch.topk` picks candidates; IVF training is
Lloyd's k-means with the same matmul in its assignment step.

The reference's four jitted device programs are plain functions on
tensors here (ROADMAP B.5): `_topk_scores`, `_kmeans`, `_kmeans_batch`
and `_pq_encode`.  Each keeps one block of scores or distances under
SCORE_BLOCK_BYTES by chunking its rows (the reference builds the whole
[Q, N] matrix).  Ties rank as `jax.lax.top_k` ranks them, lower index
first, and argmins take the first minimum, as numpy's and jnp's do.
The centroid update sums each cluster's members with `index_add_`
(the reference multiplies by a one-hot matrix; both are the member sums,
added in another order: on the card in atomic order, so a build is
reproducible to float rounding, not bit for bit).

What stays on the host, as in the reference: the random draws (numpy's
`default_rng(seed)`, so both packages pick the same initial centroids,
samples and HNSW levels), the IVF layout, every IVF query loop (a given
index state answers bit for bit as the reference's does) and HNSW, a
pointer-chasing graph that takes no device.  The IVF builds upload the
vectors once and run the coarse assignment and the SQ8 encode on the
card too, as the same float32 expressions the reference runs in numpy.

Metrics: 'dot' | 'cosine' | 'l2' (l2 via the ||a-b||^2 expansion so it
stays one matmul).
"""

from __future__ import annotations

import io
import json
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from paimon_tpu_torch.device import resolve_device

__all__ = ["BruteForceIndex", "IVFFlatIndex", "IVFPQIndex",
           "IVFSQIndex", "HNSWIndex", "PersistedVectorIndex",
           "vector_search"]

# one block of scores (int64 ranking keys) or of distances (float32) in
# bytes at most; rows are chunked to fit
SCORE_BLOCK_BYTES = 1 << 31
_LOW32 = 0xFFFFFFFF


def _as_matrix(col: pa.ChunkedArray) -> np.ndarray:
    """fixed_size_list / list<float> column -> float32 [N, D]."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_fixed_size_list(arr.type):
        d = arr.type.list_size
        flat = np.asarray(arr.flatten().cast(pa.float32()))
        return flat.reshape(len(arr), d)
    values = arr.to_pylist()
    return np.asarray(values, dtype=np.float32)


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A float32 host array as a tensor on `dev` (one copy)."""
    return torch.from_numpy(np.require(a, np.float32, ["C", "W"])).to(dev)


def _rows_per_block(cols: int, itemsize: int) -> int:
    return max(1, SCORE_BLOCK_BYTES // (itemsize * max(cols, 1)))


def _ranking_keys(sims: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score descending, corpus
    index ascending): the float's bits made monotone in its value in the
    high word, `low` (2^32 - 1 - index) in the low word.  -0.0 is added
    to 0.0 first, so equal scores share the high word."""
    bits = (sims + 0.0).view(torch.int32).to(torch.int64)
    bits ^= (bits >> 63) & 0x7FFFFFFF
    return bits.mul_(1 << 32).add_(low)


def _topk_scores(queries: torch.Tensor, corpus: torch.Tensor,
                 corpus_sq: torch.Tensor, k: int, metric: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D] x corpus [N, D] -> (scores [Q, k], idx [Q, k]),
    best first, ties to the lower corpus index (reference `:41`)."""
    n = corpus.shape[0]
    low = _LOW32 - torch.arange(n, device=corpus.device, dtype=torch.int64)
    rows = _rows_per_block(n, 8)
    scores, idx = [], []
    for lo in range(0, queries.shape[0], rows):
        q = queries[lo:lo + rows]
        sims = q @ corpus.T
        if metric == "cosine":
            qn = torch.linalg.norm(q, dim=1, keepdim=True)
            cn = torch.sqrt(corpus_sq)[None, :]
            sims = sims / torch.clamp(qn * cn, min=1e-12)
        elif metric == "l2":
            qsq = torch.sum(q * q, dim=1, keepdim=True)
            sims = -(qsq + corpus_sq[None, :] - 2.0 * sims)  # -distance^2
        top = torch.topk(_ranking_keys(sims, low), k, dim=1).indices
        scores.append(torch.gather(sims, 1, top))
        idx.append(top)
    if not idx:
        return (torch.zeros((0, k), dtype=torch.float32,
                            device=corpus.device),
                torch.zeros((0, k), dtype=torch.int64,
                            device=corpus.device))
    return torch.cat(scores), torch.cat(idx)


class BruteForceIndex:
    """Exact search: one matmul over the whole corpus, which stays on
    `device` (None = cuda) with its squared norms."""

    def __init__(self, vectors: np.ndarray, metric: str = "cosine",
                 device=None):
        self.metric = metric
        self.device = resolve_device(device)
        self._corpus = _on(np.asarray(vectors, dtype=np.float32),
                           self.device)
        self._corpus_sq = torch.sum(self._corpus * self._corpus, dim=1)

    def __len__(self) -> int:
        return int(self._corpus.shape[0])

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], indices [Q, k]); higher score = closer."""
        q = torch.atleast_2d(_on(np.asarray(queries, dtype=np.float32),
                                 self.device))
        k = min(k, len(self))
        scores, idx = _topk_scores(q, self._corpus, self._corpus_sq, k,
                                   self.metric)
        return (scores.cpu().numpy(),
                idx.to(torch.int32).cpu().numpy())


def _assign(vectors: torch.Tensor, centroids: torch.Tensor,
            vsq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest centroid of each vector (the first on ties): the argmin of
    ||v||^2 + ||c||^2 - 2 v.c, in row blocks."""
    if vsq is None:
        vsq = torch.sum(vectors ** 2, dim=1, keepdim=True)
    csq = torch.sum(centroids ** 2, dim=1)[None, :]
    out = torch.empty(vectors.shape[0], dtype=torch.int64,
                      device=vectors.device)
    rows = _rows_per_block(centroids.shape[0], 4)
    for lo in range(0, vectors.shape[0], rows):
        d = vsq[lo:lo + rows] + csq \
            - 2.0 * vectors[lo:lo + rows] @ centroids.T
        out[lo:lo + rows] = torch.argmin(d, dim=1)
    return out


def _kmeans(vectors: torch.Tensor, init_centroids: torch.Tensor,
            iters: int) -> torch.Tensor:
    """Lloyd's iterations on the vectors' device (reference `:76`):
    assignment by argmin, each centroid the mean of its members, an
    empty cluster keeping its centroid."""
    centroids = init_centroids
    vsq = torch.sum(vectors ** 2, dim=1, keepdim=True)
    for _ in range(iters):
        assign = _assign(vectors, centroids, vsq)
        sums = torch.zeros_like(centroids).index_add_(0, assign, vectors)
        counts = torch.bincount(assign, minlength=centroids.shape[0]) \
            .to(vectors.dtype)[:, None]
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1),
                                centroids)
    return centroids


def _assign_batch(subvectors: torch.Tensor, codebooks: torch.Tensor,
                  vsq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """_assign in each of M subspaces at once: subvectors [M, S, dsub],
    codebooks [M, K, dsub] -> [M, S] (bmm, in blocks of S)."""
    if vsq is None:
        vsq = torch.sum(subvectors * subvectors, dim=2, keepdim=True)
    m, s, _ = subvectors.shape
    csq = torch.sum(codebooks * codebooks, dim=2)[:, None, :]
    out = torch.empty((m, s), dtype=torch.int64, device=subvectors.device)
    rows = _rows_per_block(m * codebooks.shape[1], 4)
    ct = codebooks.transpose(1, 2)
    for lo in range(0, s, rows):
        d = vsq[:, lo:lo + rows] + csq \
            - 2.0 * torch.bmm(subvectors[:, lo:lo + rows], ct)
        out[:, lo:lo + rows] = torch.argmin(d, dim=2)
    return out


def _kmeans_batch(subvectors: torch.Tensor, init_centroids: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """Per-subspace Lloyd's over the M subspaces at once (reference
    `:210`): subvectors [M, N, dsub], init [M, ksub, dsub] -> [M, ksub,
    dsub].  The assignment is one batched matmul; the update sums every
    subspace's clusters in one index_add_ over M * ksub rows."""
    m, n, dsub = subvectors.shape
    ksub = init_centroids.shape[1]
    centroids = init_centroids
    vsq = torch.sum(subvectors * subvectors, dim=2, keepdim=True)
    flat = subvectors.reshape(m * n, dsub)
    offs = (torch.arange(m, device=subvectors.device) * ksub)[:, None]
    for _ in range(iters):
        gid = (_assign_batch(subvectors, centroids, vsq) + offs) \
            .reshape(-1)
        sums = torch.zeros((m * ksub, dsub), dtype=subvectors.dtype,
                           device=subvectors.device) \
            .index_add_(0, gid, flat).reshape(m, ksub, dsub)
        counts = torch.bincount(gid, minlength=m * ksub) \
            .to(subvectors.dtype).reshape(m, ksub, 1)
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1),
                                centroids)
    return centroids


def _pq_encode(subvectors: torch.Tensor, codebooks: torch.Tensor
               ) -> torch.Tensor:
    """subvectors [M, N, dsub] x codebooks [M, ksub, dsub] -> codes
    [N, M] uint8: the nearest codeword in each subspace (reference
    `:220`)."""
    return _assign_batch(subvectors, codebooks).to(torch.uint8).T


class IVFFlatIndex:
    """IVF-Flat: k-means coarse quantizer on `device` (None = cuda) +
    per-cluster exact search on the host.

    Probing is two matmuls: queries x centroids picks nprobe clusters,
    then queries x (gathered members) ranks candidates."""

    def __init__(self, vectors: np.ndarray, n_clusters: int = 0,
                 metric: str = "cosine", kmeans_iters: int = 8,
                 seed: int = 0, device=None):
        dev = resolve_device(device)
        n = len(vectors)
        if n_clusters <= 0:
            n_clusters = max(1, int(np.sqrt(n)))
        n_clusters = min(n_clusters, n)
        self.metric = metric
        rng = np.random.default_rng(seed)
        v, centroids, assign = _coarse(
            np.asarray(vectors, dtype=np.float32), n_clusters,
            kmeans_iters, rng, dev)
        self.centroids = centroids.cpu().numpy()
        members, self._bounds = _layout(assign.cpu().numpy(), n_clusters)
        self._members = members.astype(np.int64)  # corpus idx by cluster
        self._vectors = np.asarray(vectors, dtype=np.float32)
        self._norms = np.linalg.norm(self._vectors, axis=1)
        self._sq = np.sum(self._vectors ** 2, axis=1)

    def __len__(self) -> int:
        return len(self._vectors)

    def search(self, queries: np.ndarray, k: int, nprobe: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        nprobe = min(nprobe, len(self._bounds) - 1)
        cd = (np.sum(q ** 2, axis=1, keepdims=True)
              + np.sum(self.centroids ** 2, axis=1)[None, :]
              - 2.0 * q @ self.centroids.T)
        probe = np.argsort(cd, axis=1)[:, :nprobe]
        out_scores = np.full((len(q), k), -np.inf, dtype=np.float32)
        out_idx = np.full((len(q), k), -1, dtype=np.int64)
        for qi in range(len(q)):
            cand = np.concatenate([
                self._members[self._bounds[c]:self._bounds[c + 1]]
                for c in probe[qi]])
            if len(cand) == 0:
                continue
            # candidate sets are small and vary per query: host numpy,
            # as the reference scores them
            sub = self._vectors[cand]
            sims = sub @ q[qi]
            if self.metric == "cosine":
                qn = max(float(np.linalg.norm(q[qi])), 1e-12)
                sims = sims / (np.maximum(self._norms[cand], 1e-12) * qn)
            elif self.metric == "l2":
                sims = -(self._sq[cand] + float(q[qi] @ q[qi])
                         - 2.0 * sims)
            kk = min(k, len(cand))
            top = np.argpartition(-sims, kk - 1)[:kk]
            top = top[np.argsort(-sims[top])]
            out_scores[qi, :kk] = sims[top]
            out_idx[qi, :kk] = cand[top]
        return out_scores, out_idx


def _coarse(v: np.ndarray, n_clusters: int, kmeans_iters: int, rng,
            dev: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The IVF coarse quantizer on `dev`: the host's draw of initial
    centroids, k-means, then every vector's cluster -> (vectors,
    centroids, assign), all on `dev`."""
    pick = rng.choice(len(v), n_clusters, replace=False)
    vd = _on(v, dev)
    centroids = _kmeans(vd, vd[torch.from_numpy(pick).to(dev)],
                        kmeans_iters)
    return vd, centroids, _assign(vd, centroids)


def _layout(assign: np.ndarray, n_clusters: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster layout on the host, as the reference's: (members [int32,
    corpus ids sorted by cluster, stable], bounds [n_clusters + 1])."""
    order = np.argsort(assign, kind="stable")
    members = order.astype(np.int32)
    bounds = np.searchsorted(assign[order], np.arange(n_clusters + 1))
    return members, bounds


def _train_coarse(v: np.ndarray, n_clusters: int, kmeans_iters: int,
                  rng, device=None) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Shared IVF coarse quantizer (k-means on `device` + cluster
    layout): -> (centroids, assign, members[int32 sorted by cluster],
    bounds)."""
    _, centroids, assign = _coarse(v, n_clusters, kmeans_iters, rng,
                                   resolve_device(device))
    assign = assign.cpu().numpy()
    members, bounds = _layout(assign, n_clusters)
    return centroids.cpu().numpy(), assign, members, bounds


def _probe_clusters(q: np.ndarray, centroids: np.ndarray,
                    nprobe: int) -> np.ndarray:
    """queries x centroids -> nearest-`nprobe` cluster ids per query."""
    cd = (np.sum(q ** 2, axis=1, keepdims=True)
          + np.sum(centroids ** 2, axis=1)[None, :]
          - 2.0 * q @ centroids.T)
    return np.argsort(cd, axis=1)[:, :nprobe]


def _select_candidates(cand: np.ndarray, dist: np.ndarray, qv: np.ndarray,
                       raw: Optional[np.ndarray], metric: str, k: int,
                       refine: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shared approximate->exact tail: top-`fetch` by approximate
    distance, optional exact rerank against raw vectors ->
    (selected corpus ids, scores)."""
    fetch = max(k, refine) if refine else k
    kk = min(fetch, len(cand))
    top = np.argpartition(dist, kk - 1)[:kk]
    if refine and raw is not None:
        sub = raw[cand[top]]
        if metric == "dot":
            ex = -(sub @ qv)
        else:                          # l2, and cosine (pre-normalized)
            ex = np.sum((sub - qv) ** 2, axis=1)
        order = np.argsort(ex, kind="stable")[:k]
        return cand[top[order]], -ex[order]
    order = np.argsort(dist[top], kind="stable")[:k]
    return cand[top[order]], -dist[top][order]


class IVFPQIndex:
    """IVF-PQ: coarse k-means quantizer + product-quantized residuals.

    reference: paimon-vector IVF-PQ factory (NativeVectorIndexLoader
    .java:28).  Training runs on `device` (None = cuda): the coarse
    k-means and assignment, the M codebooks trained at once
    (`_kmeans_batch`) on a sample of at most 262,144 residuals, and the
    encode of every residual in chunks of 2^18 (`_pq_encode`).  The
    compressed corpus is N x M bytes (32x smaller than f32 at D=128,
    M=16); it and the query loop live on the host.

    Asymmetric distance (ADC): for query q probing cluster c with
    residual r = q - centroid[c], LUT[m][j] = ||r_m - codebook[m][j]||²
    and member distance = sum_m LUT[m][code[m]].  `refine > 0` reranks
    the top ADC candidates with exact distances against the raw
    vectors (kept out of the index's memory budget: pass them to
    `search(..., vectors=...)` or let the index hold a reference).
    """

    KSUB = 256                      # 8-bit codes
    SAMPLE = 262_144                # residuals the codebooks train on
    ENCODE_ROWS = 1 << 18           # residuals encoded a chunk

    def __init__(self, vectors: Optional[np.ndarray],
                 n_clusters: int = 0, m: int = 8,
                 metric: str = "l2", kmeans_iters: int = 8,
                 seed: int = 0, keep_vectors: bool = True,
                 _from_state: Optional[dict] = None, device=None):
        if _from_state is not None:
            self.__dict__.update(_from_state)
            return
        dev = resolve_device(device)
        n, d = vectors.shape
        if d % m:
            raise ValueError(f"dim {d} not divisible by m={m} subspaces")
        if n_clusters <= 0:
            n_clusters = max(1, int(np.sqrt(n)))
        n_clusters = min(n_clusters, n)
        self.metric = metric
        self.m = m
        self.dsub = d // m
        v = np.asarray(vectors, dtype=np.float32)
        if metric == "cosine":
            # normalized l2 ranks identically to cosine
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                               1e-12)
        rng = np.random.default_rng(seed)
        vd, centroids, assign = _coarse(v, n_clusters, kmeans_iters, rng,
                                        dev)
        self.centroids = centroids.cpu().numpy()
        self._members, self._bounds = _layout(assign.cpu().numpy(),
                                              n_clusters)

        # PQ codebooks on residuals (train on a sample when huge)
        resid = vd - centroids[assign]
        del vd
        sample = resid if n <= self.SAMPLE else resid[torch.from_numpy(
            rng.choice(n, self.SAMPLE, replace=False)).to(dev)]
        s = len(sample)
        sub = sample.reshape(s, m, self.dsub).permute(1, 0, 2) \
            .contiguous()                                # [M, S, dsub]
        ksub = min(self.KSUB, s)
        cb_init = torch.stack([sub[j][torch.from_numpy(
            rng.choice(s, ksub, replace=False)).to(dev)]
            for j in range(m)])
        codebooks = _kmeans_batch(sub, cb_init, kmeans_iters)
        del sub, sample
        self.codebooks = codebooks.cpu().numpy()
        # encode ALL residuals on the device, chunked for memory
        codes = np.empty((n, m), dtype=np.uint8)
        step = self.ENCODE_ROWS
        for lo in range(0, n, step):
            chunk = resid[lo:lo + step]
            subc = chunk.reshape(len(chunk), m, self.dsub) \
                .permute(1, 0, 2).contiguous()
            codes[lo:lo + step] = _pq_encode(subc, codebooks).cpu().numpy()
        self.codes = codes
        self._vectors = v if keep_vectors else None

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def memory_bytes(self) -> int:
        """Resident footprint of the compressed index (codes +
        codebooks + coarse centroids + member lists) — what RAM/HBM
        must hold; raw vectors are NOT included (refine streams them)."""
        return (self.codes.nbytes + self.codebooks.nbytes
                + self.centroids.nbytes + self._members.nbytes
                + self._bounds.nbytes)

    # -- persistence --------------------------------------------------
    def state(self) -> Tuple[dict, dict]:
        """(json_meta, named_arrays) for the index layout."""
        meta = {"kind": "ivfpq", "metric": self.metric, "m": self.m,
                "dsub": self.dsub}
        arrays = {"centroids": self.centroids,
                  "codebooks": self.codebooks, "codes": self.codes,
                  "members": self._members, "bounds": self._bounds}
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   vectors: Optional[np.ndarray] = None) -> "IVFPQIndex":
        return cls(None, _from_state={
            "metric": meta["metric"], "m": meta["m"],
            "dsub": meta["dsub"],
            "centroids": arrays["centroids"],
            "codebooks": arrays["codebooks"],
            "codes": arrays["codes"],
            "_members": arrays["members"],
            "_bounds": arrays["bounds"],
            "_vectors": vectors})

    # -- query --------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, nprobe: int = 8,
               refine: int = 0, vectors: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], indices [Q, k]); higher score = closer.
        `refine`: rerank the top `refine` ADC candidates exactly
        against raw vectors (self's, or the `vectors` argument)."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-12)
        nprobe = min(nprobe, len(self._bounds) - 1)
        probe = _probe_clusters(q, self.centroids, nprobe)
        raw = vectors if vectors is not None else self._vectors
        out_scores = np.full((len(q), k), -np.inf, dtype=np.float32)
        out_idx = np.full((len(q), k), -1, dtype=np.int64)
        cb = self.codebooks                      # [M, ksub, dsub]
        cb_sq = np.sum(cb ** 2, axis=2)          # [M, ksub]
        marange = np.arange(self.m)
        for qi in range(len(q)):
            cand_parts, dist_parts = [], []
            for c in probe[qi]:
                lo, hi = self._bounds[c], self._bounds[c + 1]
                if lo == hi:
                    continue
                members = self._members[lo:hi]
                r = q[qi] - self.centroids[c]
                rsub = r.reshape(self.m, 1, self.dsub)
                # LUT build = batched matmul: [M, 1, dsub]x[M, dsub,
                # ksub]; member distance = gather + sum over subspaces
                lut = (np.sum(rsub ** 2, axis=2) + cb_sq
                       - 2.0 * np.einsum("mod,mkd->mk", rsub, cb))
                codes = self.codes[members]      # [nc, M] uint8
                dist = lut[marange[None, :], codes].sum(axis=1)
                cand_parts.append(members)
                dist_parts.append(dist)
            if not cand_parts:
                continue
            sel, scores = _select_candidates(
                np.concatenate(cand_parts), np.concatenate(dist_parts),
                q[qi], raw, self.metric, k, refine)
            out_idx[qi, :len(sel)] = sel
            out_scores[qi, :len(sel)] = scores
        return out_scores, out_idx


class IVFSQIndex:
    """IVF-SQ8: coarse k-means quantizer + int8 scalar-quantized
    residuals (4x smaller than f32).

    reference: paimon-vector IvfHnswSqVectorGlobalIndexerFactory.java
    (the SQ capability; HNSW's graph half is HNSWIndex below).  The
    coarse quantizer and the per-dimension affine SQ8 encode of the
    residuals run on `device` (None = cuda), the same float32
    expressions as the reference's numpy (round half to even); the
    compressed corpus (N x D bytes) and the query loop live on the host.
    """

    def __init__(self, vectors: Optional[np.ndarray],
                 n_clusters: int = 0, metric: str = "l2",
                 kmeans_iters: int = 8, seed: int = 0,
                 keep_vectors: bool = True,
                 _from_state: Optional[dict] = None, device=None):
        if _from_state is not None:
            self.__dict__.update(_from_state)
            return
        dev = resolve_device(device)
        n, d = vectors.shape
        if n_clusters <= 0:
            n_clusters = max(1, int(np.sqrt(n)))
        n_clusters = min(n_clusters, n)
        self.metric = metric
        v = np.asarray(vectors, dtype=np.float32)
        raw = v
        if metric == "cosine":
            v = raw = v / np.maximum(
                np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        elif metric == "dot":
            # MIPS -> L2 (Bachrach et al. / ScaNN's standard reduction):
            # append phi = sqrt(M^2 - ||x||^2); with queries padded by 0,
            # l2-NN in the augmented space orders exactly by dot product,
            # making IVF's l2 cluster geometry sound for inner product
            norms_sq = np.sum(v ** 2, axis=1)
            self.mips_max_norm = float(np.sqrt(norms_sq.max(initial=0.0)))
            phi = np.sqrt(np.maximum(
                self.mips_max_norm ** 2 - norms_sq, 0.0))
            v = np.concatenate([v, phi[:, None]], axis=1) \
                .astype(np.float32)
        rng = np.random.default_rng(seed)
        vd, centroids, assign = _coarse(v, n_clusters, kmeans_iters, rng,
                                        dev)
        self.centroids = centroids.cpu().numpy()
        self._members, self._bounds = _layout(assign.cpu().numpy(),
                                              n_clusters)
        # per-dimension affine SQ8 over residuals: code = round(
        # (r - min) / scale), r ~ min + code * scale
        resid = vd - centroids[assign]
        del vd
        sq_min = resid.min(dim=0).values
        span = resid.max(dim=0).values - sq_min
        sq_scale = torch.where(span > 0, span / 255.0,
                               torch.ones_like(span))
        self.sq_min = sq_min.cpu().numpy()
        self.sq_scale = sq_scale.cpu().numpy()
        self.codes = torch.clamp(torch.round((resid - sq_min) / sq_scale),
                                 0, 255).to(torch.uint8).cpu().numpy()
        # refine reranks against the ORIGINAL vectors (for dot, the
        # augmented space is for candidate generation only)
        self._vectors = raw if keep_vectors else None

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def memory_bytes(self) -> int:
        return (self.codes.nbytes + self.centroids.nbytes
                + self.sq_min.nbytes + self.sq_scale.nbytes
                + self._members.nbytes + self._bounds.nbytes)

    # -- persistence --------------------------------------------------
    def state(self) -> Tuple[dict, dict]:
        meta = {"kind": "ivfsq", "metric": self.metric}
        if self.metric == "dot":
            meta["mips_max_norm"] = self.mips_max_norm
        arrays = {"centroids": self.centroids, "codes": self.codes,
                  "sq_min": self.sq_min, "sq_scale": self.sq_scale,
                  "members": self._members, "bounds": self._bounds}
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   vectors: Optional[np.ndarray] = None) -> "IVFSQIndex":
        state = {
            "metric": meta["metric"],
            "centroids": arrays["centroids"],
            "codes": arrays["codes"], "sq_min": arrays["sq_min"],
            "sq_scale": arrays["sq_scale"],
            "_members": arrays["members"], "_bounds": arrays["bounds"],
            "_vectors": vectors}
        if "mips_max_norm" in meta:
            state["mips_max_norm"] = meta["mips_max_norm"]
        return cls(None, _from_state=state)

    # -- query --------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, nprobe: int = 8,
               refine: int = 0, vectors: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-12)
        if self.metric == "dot":
            # augmented-space probe (phi component of a query is 0)
            q_work = np.concatenate(
                [q, np.zeros((len(q), 1), np.float32)], axis=1)
        else:
            q_work = q
        nprobe = min(nprobe, len(self._bounds) - 1)
        probe = _probe_clusters(q_work, self.centroids, nprobe)
        raw = vectors if vectors is not None else self._vectors
        out_scores = np.full((len(q), k), -np.inf, dtype=np.float32)
        out_idx = np.full((len(q), k), -1, dtype=np.int64)
        for qi in range(len(q)):
            cand_parts, dist_parts = [], []
            for c in probe[qi]:
                lo, hi = self._bounds[c], self._bounds[c + 1]
                if lo == hi:
                    continue
                members = self._members[lo:hi]
                r = q_work[qi] - self.centroids[c]
                # dequantized residual distance, vectorized over the
                # cluster: ||r - (min + code*scale)||^2
                deq = self.codes[members] * self.sq_scale + self.sq_min
                diff = deq - r
                dist_parts.append(np.einsum("nd,nd->n", diff, diff))
                cand_parts.append(members)
            if not cand_parts:
                continue
            sel, scores = _select_candidates(
                np.concatenate(cand_parts), np.concatenate(dist_parts),
                q[qi], raw, self.metric, k, refine)
            out_idx[qi, :len(sel)] = sel
            out_scores[qi, :len(sel)] = scores
        return out_scores, out_idx


class HNSWIndex:
    """Hierarchical navigable small-world graph — the HOST-side
    low-latency point-query structure (reference
    IvfHnswFlatVectorGlobalIndexerFactory.java / jvector-style native
    HNSW).  Graph walks are pointer-chasing, the one shape an
    accelerator is wrong for, so this lives on the host and takes no
    device, as in the reference: bulk scans use the matmul indexes
    above, single-query lookups use this.

    Standard construction (Malkov & Yashunin 2016): exponentially
    distributed levels, greedy descent from the top layer, beam search
    (ef) with M-edge neighbor selection per layer."""

    def __init__(self, vectors: Optional[np.ndarray], m: int = 16,
                 ef_construction: int = 100, metric: str = "l2",
                 seed: int = 0, _from_state: Optional[dict] = None):
        if _from_state is not None:
            self.__dict__.update(_from_state)
            return
        if metric not in ("l2", "cosine"):
            # graph edges are built on l2 geometry; cosine reduces to
            # l2 after normalization, but max-inner-product does not —
            # refuse rather than silently rank by the wrong metric
            raise ValueError(f"HNSW supports l2/cosine, not {metric!r}")
        v = np.asarray(vectors, dtype=np.float32)
        if metric == "cosine":
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                               1e-12)
        self.metric = metric
        self.m = m
        self._vectors = v
        n = len(v)
        rng = np.random.default_rng(seed)
        ml = 1.0 / np.log(max(m, 2))
        levels = np.minimum(
            (-np.log(rng.uniform(size=n)) * ml).astype(np.int64), 8)
        self.levels = levels
        self.max_level = int(levels.max(initial=0))
        # neighbors[level][node] -> int64 array of edges
        self.neighbors = [dict() for _ in range(self.max_level + 1)]
        self.entry = 0
        for i in range(n):
            self._insert(i, ef_construction)

    def _dist(self, q: np.ndarray, ids) -> np.ndarray:
        sub = self._vectors[ids]
        d = sub - q
        return np.einsum("nd,nd->n", d, d)

    def _search_layer(self, q: np.ndarray, entry: int, ef: int,
                      level: int) -> list:
        """Beam search one layer -> [(dist, node)] sorted ascending."""
        import heapq
        d0 = float(self._dist(q, [entry])[0])
        visited = {entry}
        cand = [(d0, entry)]               # min-heap by distance
        best = [(-d0, entry)]              # max-heap (worst of the ef)
        while cand:
            d, node = heapq.heappop(cand)
            if d > -best[0][0]:
                break
            nbrs = [x for x in self.neighbors[level].get(node, ())
                    if x not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            for dn, nb in zip(self._dist(q, nbrs), nbrs):
                dn = float(dn)
                if len(best) < ef or dn < -best[0][0]:
                    heapq.heappush(cand, (dn, nb))
                    heapq.heappush(best, (-dn, nb))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-d, n) for d, n in best)

    def _select(self, found: list) -> np.ndarray:
        return np.asarray([n for _, n in found[:self.m]], np.int64)

    def _insert(self, i: int, ef: int):
        if i == 0:
            for lv in range(self.levels[0] + 1):
                self.neighbors[lv][0] = np.empty(0, np.int64)
            self.entry = 0
            return
        q = self._vectors[i]
        lvl = int(self.levels[i])
        cur = self.entry
        for lv in range(self.max_level, lvl, -1):
            found = self._search_layer(q, cur, 1, lv)
            if found:
                cur = found[0][1]
        for lv in range(min(lvl, self.max_level), -1, -1):
            found = self._search_layer(q, cur, ef, lv)
            sel = self._select(found)
            self.neighbors[lv][i] = sel
            for nb in sel:
                old = self.neighbors[lv].get(int(nb),
                                             np.empty(0, np.int64))
                merged = np.append(old, i)
                if len(merged) > self.m * 2:   # prune worst edges
                    d = self._dist(self._vectors[int(nb)], merged)
                    merged = merged[np.argsort(d)[:self.m * 2]]
                self.neighbors[lv][int(nb)] = merged
            if found:
                cur = found[0][1]
        if lvl > int(self.levels[self.entry]):
            self.entry = i

    def __len__(self) -> int:
        return len(self._vectors)

    def search(self, queries: np.ndarray, k: int, ef: int = 64
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-12)
        out_scores = np.full((len(q), k), -np.inf, dtype=np.float32)
        out_idx = np.full((len(q), k), -1, dtype=np.int64)
        for qi in range(len(q)):
            cur = self.entry
            for lv in range(self.max_level, 0, -1):
                found = self._search_layer(q[qi], cur, 1, lv)
                if found:
                    cur = found[0][1]
            found = self._search_layer(q[qi], cur, max(ef, k), 0)[:k]
            for j, (d, node) in enumerate(found):
                out_scores[qi, j] = -d
                out_idx[qi, j] = node
        return out_scores, out_idx

    # -- persistence --------------------------------------------------
    def state(self) -> Tuple[dict, dict]:
        meta = {"kind": "hnsw", "metric": self.metric, "m": self.m,
                "entry": int(self.entry),
                "max_level": self.max_level}
        arrays = {"vectors": self._vectors, "levels": self.levels}
        for lv, layer in enumerate(self.neighbors):
            nodes = np.asarray(sorted(layer), np.int64)
            flat = np.concatenate(
                [layer[int(x)] for x in nodes]) if len(nodes) \
                else np.empty(0, np.int64)
            offs = np.zeros(len(nodes) + 1, np.int64)
            if len(nodes):
                offs[1:] = np.cumsum(
                    [len(layer[int(x)]) for x in nodes])
            arrays[f"l{lv}_nodes"] = nodes
            arrays[f"l{lv}_flat"] = flat
            arrays[f"l{lv}_offs"] = offs
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict,
                   vectors: Optional[np.ndarray] = None) -> "HNSWIndex":
        neighbors = []
        lv = 0
        while f"l{lv}_nodes" in arrays:
            nodes = arrays[f"l{lv}_nodes"]
            flat = arrays[f"l{lv}_flat"]
            offs = arrays[f"l{lv}_offs"]
            neighbors.append({
                int(n): flat[offs[j]:offs[j + 1]]
                for j, n in enumerate(nodes)})
            lv += 1
        return cls(None, _from_state={
            "metric": meta["metric"], "m": meta["m"],
            "entry": meta["entry"], "max_level": meta["max_level"],
            "levels": arrays["levels"],
            "neighbors": neighbors,
            "_vectors": arrays["vectors"]})


_INDEX_KINDS = {"ivfpq": IVFPQIndex, "ivfsq": IVFSQIndex,
                "hnsw": HNSWIndex}


class PersistedVectorIndex:
    """ANN index persisted in the table's index layout:
    `{table}/index/vector/{column}/` holding meta.json + npz arrays
    (reference: the vector index files the native loader mmaps,
    NativeVectorIndexLoader.java:28), the reference's layout: each
    package loads the other's.  Builds on the table's device; rebuilds
    when stale; loads without touching raw vectors otherwise."""

    VERSION = 1

    def __init__(self, table, column: str):
        self.table = table
        self.column = column

    @property
    def _dir(self) -> str:
        return f"{self.table.path}/index/vector/{self.column}"

    def build(self, m: int = 8, n_clusters: int = 0,
              metric: str = "l2", seed: int = 0, kind: str = "ivfpq"):
        latest = self.table.latest_snapshot()
        if latest is None:
            raise ValueError("empty table has no vector index")
        data = self.table.to_arrow(projection=[self.column])
        vectors = _as_matrix(data.column(self.column))
        if kind == "ivfpq":
            idx = IVFPQIndex(vectors, n_clusters=n_clusters, m=m,
                             metric=metric, seed=seed,
                             keep_vectors=False, device=self.table.device)
        elif kind == "ivfsq":
            idx = IVFSQIndex(vectors, n_clusters=n_clusters,
                             metric=metric, seed=seed,
                             keep_vectors=False, device=self.table.device)
        elif kind == "hnsw":
            idx = HNSWIndex(vectors, m=max(m, 8), metric=metric,
                            seed=seed)
        else:
            raise ValueError(f"unknown vector index kind {kind!r}")
        self._write(latest.id, *idx.state())
        return idx

    def _write(self, snapshot_id: int, meta: dict, arrays: dict) -> None:
        # the reference's npz with its arrays stored, not deflated (np.load
        # reads both): quantized codes barely compress (112 of 128 MB of
        # SQ8 codes at 1M x 128) and deflate ran at ~20 MB/s
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        fio = self.table.file_io
        fio.write_bytes(f"{self._dir}/index-{snapshot_id}.npz",
                        buf.getvalue(), overwrite=True)
        meta.update(version=self.VERSION, snapshot_id=snapshot_id,
                    column=self.column,
                    file=f"index-{snapshot_id}.npz")
        fio.write_bytes(f"{self._dir}/meta.json",
                        json.dumps(meta).encode(), overwrite=True)

    def load(self):
        fio = self.table.file_io
        try:
            meta = json.loads(fio.read_bytes(f"{self._dir}/meta.json"))
            if meta.get("version") != self.VERSION or \
                    meta.get("column") != self.column:
                return None
            latest = self.table.latest_snapshot()
            if latest is None or meta.get("snapshot_id") != latest.id:
                return None                       # stale: caller rebuilds
            with np.load(io.BytesIO(
                    fio.read_bytes(f"{self._dir}/{meta['file']}"))) as z:
                arrays = {k: z[k] for k in z.files}
            cls = _INDEX_KINDS.get(meta.get("kind", "ivfpq"))
            if cls is None:
                return None
            return cls.from_state(meta, arrays)
        except (FileNotFoundError, OSError, ValueError, KeyError):
            return None

    def load_or_build(self, **kw) -> IVFPQIndex:
        idx = self.load()
        return idx if idx is not None else self.build(**kw)


def vector_search(table, column: str, query, k: int = 10,
                  metric: str = "cosine",
                  index: Optional[BruteForceIndex] = None) -> pa.Table:
    """Search a table's embedding column; returns the top-k rows with a
    `_score` column (reference VectorSearchTable / VectorSearchSplit).
    A batch of queries ([Q, D]) returns Q*k rows with a `_query` column
    identifying the source query.  The read and the brute-force index
    run on the table's device; the rows of every query are taken at
    once (the reference's rows, a take a query there)."""
    data = table.to_arrow()
    vectors = _as_matrix(data.column(column))
    idx = index or BruteForceIndex(vectors, metric, device=table.device)
    q = np.asarray(query, dtype=np.float32)
    scores, ids = idx.search(q, k)
    valid = ids >= 0
    rows = data.take(pa.array(ids[valid]))
    rows = rows.append_column("_score",
                              pa.array(scores[valid], pa.float32()))
    if q.ndim == 2:
        rows = rows.append_column("_query", pa.array(
            np.nonzero(valid)[0], pa.int32()))
    return rows
