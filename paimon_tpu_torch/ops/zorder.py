"""Space-filling-curve keys for clustering, on the table's device.

Counterpart of paimon_tpu/ops/zorder.py (reference sort/zorder/
ZIndexer.java, sort/hilbert/HilbertIndexer.java), used by sort-compact
to cluster append tables for pruning.

Each order-by column is encoded to order-preserving u32 lanes on the
host (ops/normkey.py), then ranked on the device: the reference's
`np.unique(axis=0, return_inverse=True)` over the column's lanes is the
changelog diff's rank program (ops/diff.py `_device_ranks`: a stable
lane sort, the neighbour-equality mask, which is the CUDA kernel on the
card, and a running count scattered back through the permutation).  A
prefix-truncated string column is ranked on its lanes as they are, as
the reference ranks it: strings that share their first 16 bytes share a
rank in both packages.  The ranks scale to the 32-bit range, the curve
bits interleave and the permutation comes from a stable sort, all as
torch ops on the same device; only the permutation comes back to the
host, for Arrow's take.  The `*_plain` functions keep the reference's
numpy computation for the tests.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pyarrow as pa
import torch

from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.ops.diff import _device_ranks
from paimon_tpu_torch.ops.merge import _stable_argsort
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder

__all__ = ["z_index", "z_order_permutation", "order_permutation",
           "hilbert_index", "hilbert_permutation", "z_index_plain",
           "z_order_permutation_plain", "order_permutation_plain",
           "hilbert_index_plain", "hilbert_permutation_plain"]

_SIGN = -(1 << 63)              # int64 with only bit 63 set
_MAX_RANK = 1 << 31             # ranks times 0xFFFFFFFF stay in int64


def _column_lanes(table: pa.Table, columns: Sequence[str]):
    """Each order-by column's own u32 lanes, [N, lanes] numpy arrays."""
    enc = NormalizedKeyEncoder([table.schema.field(c).type
                                for c in columns],
                               nullable=[table.schema.field(c).nullable
                                         for c in columns])
    lanes, _ = enc.encode_table(table, columns)
    lanes = np.asarray(lanes)
    out, pos = [], 0
    for nl in enc.lanes_per_col:
        out.append(np.ascontiguousarray(lanes[:, pos:pos + nl]))
        pos += nl
    return out


def _normalized_u32(table: pa.Table, columns: Sequence[str],
                    device) -> torch.Tensor:
    """int64[N, C] on `device`: each column's dense rank scaled to the
    32-bit range (the reference's uint64 `inv * 0xFFFFFFFF // max`,
    exact in int64 while ranks stay below 2^31)."""
    dev = resolve_device(device)
    n = table.num_rows
    out = torch.zeros((n, len(columns)), dtype=torch.int64, device=dev)
    for i, sub in enumerate(_column_lanes(table, columns)):
        if n == 0:
            continue
        inv = _device_ranks([sub], None, dev)
        mx = int(inv.max())
        if mx >= _MAX_RANK:
            raise ValueError(
                f"sort-compact: {mx + 1} distinct values of "
                f"{columns[i]!r} in one bucket; ranks must stay below "
                f"2^31")
        out[:, i] = inv * 0xFFFFFFFF // max(mx, 1)
    return out


def _z_bits(mat: torch.Tensor) -> torch.Tensor:
    """int64[N]: the z-order key's 64 bits (bit 63 as the sign bit)."""
    n, c = mat.shape
    bits_per_col = 64 // c
    # keep the top bits_per_col bits of each column
    vals = mat >> (32 - min(32, bits_per_col))
    out = torch.zeros(n, dtype=torch.int64, device=mat.device)
    for b in range(bits_per_col):
        # bit (bits_per_col-1-b) of each column, interleaved round-robin
        src_bit = bits_per_col - 1 - b
        if src_bit >= 32:
            continue                      # above every 32-bit value
        for ci in range(c):
            dst_bit = 63 - (b * c + ci)
            bit = (vals[:, ci] >> src_bit) & 1
            out |= (-bit & _SIGN) if dst_bit == 63 else bit << dst_bit
    return out


def _unsigned_order(keys: torch.Tensor) -> torch.Tensor:
    """Stable permutation of int64 keys read as uint64: the sign bit
    flipped, then a stable signed sort."""
    return torch.sort(keys ^ _SIGN, stable=True).indices


def z_index(table: pa.Table, columns: Sequence[str],
            device=None) -> np.ndarray:
    """uint64[N] z-order (Morton) keys over `columns`."""
    keys = _z_bits(_normalized_u32(table, columns, device))
    return keys.cpu().numpy().view(np.uint64)


def z_order_permutation(table: pa.Table, columns: Sequence[str],
                        device=None) -> np.ndarray:
    mat = _normalized_u32(table, columns, device)
    return _unsigned_order(_z_bits(mat)).cpu().numpy()


def order_permutation(table: pa.Table, columns: Sequence[str],
                      device=None) -> np.ndarray:
    """Plain lexicographic clustering (reference OrderSorter): a stable
    lexicographic sort by the rank columns, the first most significant."""
    mat = _normalized_u32(table, columns, device)
    if mat.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    return _stable_argsort(list(mat.T)).cpu().numpy()


def _hilbert_bits(mat: torch.Tensor) -> torch.Tensor:
    """int64[N] Hilbert-curve keys (Skilling's transpose algorithm,
    vectorised over rows; at most 63 bits, so never negative)."""
    n_rows, n_dims = mat.shape
    bits = min(32, max(1, 63 // n_dims))
    # ranks truncated to `bits` per dimension
    X = [mat[:, i] >> (32 - bits) for i in range(n_dims)]

    # AxesToTranspose (Skilling, AIP Conf. Proc. 707, 2004)
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(n_dims):
            cond = (X[i] & Q) != 0
            X[0] = torch.where(cond, X[0] ^ P, X[0])
            t = torch.where(cond, torch.zeros_like(X[0]), (X[0] ^ X[i]) & P)
            X[0] = X[0] ^ t
            X[i] = X[i] ^ t
        Q >>= 1
    for i in range(1, n_dims):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros(n_rows, dtype=torch.int64, device=mat.device)
    Q = M
    while Q > 1:
        has = (X[n_dims - 1] & Q) != 0
        t = torch.where(has, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(n_dims):
        X[i] = X[i] ^ t

    # interleave the transpose bits (most significant first)
    out = torch.zeros(n_rows, dtype=torch.int64, device=mat.device)
    for b in range(bits - 1, -1, -1):
        for i in range(n_dims):
            out = (out << 1) | ((X[i] >> b) & 1)
    return out


def hilbert_index(table: pa.Table, columns: Sequence[str],
                  device=None) -> np.ndarray:
    """uint64[N] Hilbert-curve keys over `columns`."""
    keys = _hilbert_bits(_normalized_u32(table, columns, device))
    return keys.cpu().numpy().view(np.uint64)


def hilbert_permutation(table: pa.Table, columns: Sequence[str],
                        device=None) -> np.ndarray:
    mat = _normalized_u32(table, columns, device)
    return torch.sort(_hilbert_bits(mat), stable=True).indices.cpu().numpy()


# -- the reference's numpy computation (tests and chip_smoke.py) -------------

def _normalized_u32_plain(table: pa.Table,
                          columns: Sequence[str]) -> np.ndarray:
    """[N, C] uint32 ranks, by np.unique as the reference computes them."""
    out = np.zeros((table.num_rows, len(columns)), dtype=np.uint32)
    for i, sub in enumerate(_column_lanes(table, columns)):
        _, inv = np.unique(sub, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mx = max(int(inv.max()) if len(inv) else 0, 1)
        out[:, i] = (inv.astype(np.uint64) * np.uint64(0xFFFFFFFF)
                     // np.uint64(mx)).astype(np.uint32)
    return out


def z_index_plain(table: pa.Table, columns: Sequence[str]) -> np.ndarray:
    mat = _normalized_u32_plain(table, columns)
    n, c = mat.shape
    bits_per_col = 64 // c
    vals = (mat >> np.uint32(32 - min(32, bits_per_col))).astype(np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits_per_col):
        src_bit = np.uint64(bits_per_col - 1 - b)
        for ci in range(c):
            dst_bit = np.uint64(64 - 1 - (b * c + ci))
            bit = (vals[:, ci] >> src_bit) & np.uint64(1)
            out |= bit << dst_bit
    return out


def z_order_permutation_plain(table: pa.Table,
                              columns: Sequence[str]) -> np.ndarray:
    return np.argsort(z_index_plain(table, columns), kind="stable")


def order_permutation_plain(table: pa.Table,
                            columns: Sequence[str]) -> np.ndarray:
    mat = _normalized_u32_plain(table, columns)
    return np.lexsort(tuple(mat[:, i] for i in reversed(range(
        mat.shape[1]))))


def hilbert_index_plain(table: pa.Table,
                        columns: Sequence[str]) -> np.ndarray:
    mat = _normalized_u32_plain(table, columns)
    n_rows, n_dims = mat.shape
    bits = min(32, max(1, 63 // n_dims))
    X = [(mat[:, i] >> np.uint32(32 - bits)).astype(np.uint64)
         for i in range(n_dims)]
    M = np.uint64(1 << (bits - 1))
    Q = int(M)
    while Q > 1:
        P = np.uint64(Q - 1)
        Qu = np.uint64(Q)
        for i in range(n_dims):
            cond = (X[i] & Qu) != 0
            X[0] = np.where(cond, X[0] ^ P, X[0])
            t = np.where(cond, np.uint64(0), (X[0] ^ X[i]) & P)
            X[0] ^= t
            X[i] ^= t
        Q >>= 1
    for i in range(1, n_dims):
        X[i] ^= X[i - 1]
    t = np.zeros(n_rows, dtype=np.uint64)
    Q = int(M)
    while Q > 1:
        has = (X[n_dims - 1] & np.uint64(Q)) != 0
        t = np.where(has, t ^ np.uint64(Q - 1), t)
        Q >>= 1
    for i in range(n_dims):
        X[i] ^= t
    out = np.zeros(n_rows, dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(n_dims):
            bit = (X[i] >> np.uint64(b)) & np.uint64(1)
            out = (out << np.uint64(1)) | bit
    return out


def hilbert_permutation_plain(table: pa.Table,
                              columns: Sequence[str]) -> np.ndarray:
    return np.argsort(hilbert_index_plain(table, columns), kind="stable")
