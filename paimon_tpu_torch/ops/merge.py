"""K-way sorted-run merge, in PyTorch.

Counterpart of paimon_tpu/ops/merge.py, with the same plan and the same
routes.  The device routes:

1. concatenate the k runs oldest-first (keeps input order for stable ties),
2. stable device sort by (validity, key lanes..., seq_hi, seq_lo, iota),
3. segmented winner selection: the neighbour-equality mask over the
   sorted lanes (ops/kernels.eq_next_mask, a CUDA kernel on the card)
   gives per-key segments; deduplicate keeps the last row of each
   segment, first-row keeps the first,
4. return take-indices into the concatenated input; the host applies
   them to the Arrow table.

The device routes return the full variant (perm, winner, prev), one
packed word per row (winners only), or one bit per row (the bitmask
return: the host recovers key order by radix-sorting the winners'
packed keys).  Their inputs are padded to the reference's power-of-two
sizes with invalid=1 rows, so the returned arrays equal the reference's
element for element.  Lanes travel as int32 tensors holding uint32 bit
patterns.

The host routes (the C radix or numpy fast route, the general lexsort,
the offset-value-coded merge of ops/ovc.py) return unpadded arrays.
On a CUDA device a cost model picks the route from the link rate the
first merge measures (`_device_path_pays`, `_bitmask_device_pays`); on
device="cpu", where the device routes run the kernels' plain versions,
the device routes are kept.  PAIMON_FORCE_DEVICE_SORT,
PAIMON_FORCE_HOST_SORT and PAIMON_FORCE_BITMASK_SORT pin a route on
either device, as in the reference.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from paimon_tpu_torch import native
from paimon_tpu_torch.device import resolve_device
from paimon_tpu_torch.ops.kernels import eq_next_mask
from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder
from paimon_tpu_torch.types import RowKind

__all__ = ["merge_runs", "MergeResult", "device_sorted_winners",
           "segmented_merge_body", "sort_table", "user_seq_order_lanes",
           "link_bandwidth", "PATH_COUNTS", "SEQ_COL", "KIND_COL"]

SEQ_COL = "_SEQUENCE_NUMBER"
KIND_COL = "_VALUE_KIND"

_INT32_MIN = -0x80000000


@dataclass
class MergeResult:
    """Indices into the concatenated input table, in key order."""
    table: pa.Table          # concatenated input (runs oldest-first)
    indices: np.ndarray      # winners, sorted by key
    # per-winner previous-version indices (for changelog), -1 if none
    prev_indices: Optional[np.ndarray] = None

    def take(self, columns: Optional[List[str]] = None) -> pa.Table:
        t = self.table.select(columns) if columns else self.table
        return t.take(pa.array(self.indices))


def _pad_size(n: int) -> int:
    if n <= 1024:
        return 1024
    return 1 << (n - 1).bit_length()


def _join_i32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 whose high and low words are the bit patterns of the
    int32 tensors `hi` and `lo` (assembled in memory, no shifts)."""
    out = torch.empty(lo.shape + (2,), dtype=torch.int32, device=lo.device)
    out[..., 0] = lo                            # little-endian
    out[..., 1] = hi
    return out.view(torch.int64).squeeze(-1)


def _u32_key(x: torch.Tensor) -> torch.Tensor:
    """int64 sort key of one 32-bit lane, in unsigned order."""
    return _join_i32(torch.zeros_like(x), x)


def _u64_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 sort key whose signed order is the unsigned order of the
    lane pair (hi, lo): hi's sign bit flipped, then joined."""
    return _join_i32(hi ^ _INT32_MIN, lo)


def _lane_sort_keys(cols: List[torch.Tensor]) -> List[torch.Tensor]:
    """int64 sort keys (most significant first) whose lexicographic
    order is the unsigned lexicographic order of the 32-bit lanes
    `cols`: lanes join in pairs from the least significant end, so an
    odd count leaves the most significant lane alone."""
    keys: List[torch.Tensor] = []
    while cols:
        if len(cols) >= 2:
            keys.insert(0, _u64_key(cols[-2], cols[-1]))
            cols = cols[:-2]
        else:
            keys.insert(0, _u32_key(cols[-1]))
            cols = []
    return keys


def _stable_argsort(keys: List[torch.Tensor]) -> torch.Tensor:
    """Permutation of a stable lexicographic sort by `keys` (most
    significant first) along the last dimension, as a
    least-significant-first chain of stable sorts; ties keep input
    order.  Keys of shape [B, N] sort each row on its own."""
    perm = torch.sort(keys[-1], dim=-1, stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm.gather(-1, torch.sort(k.gather(-1, perm), dim=-1,
                                          stable=True).indices)
    return perm


def segmented_merge_body(lanes: torch.Tensor, seq_hi: torch.Tensor,
                         seq_lo: torch.Tensor, invalid: torch.Tensor,
                         keep: str, num_key_lanes: Optional[int] = None,
                         ovc_off: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(perm, winner, prev_in_seg) over one padded batch, or over a
    [B, N] stack of B independent batches (the mesh's bucket lanes).

    lanes: int32[L, N] or int32[L, B, N] (uint32 bit patterns, most
    significant first); the first `num_key_lanes` define segment
    identity, further lanes are user-defined sequence order.
    seq_hi/seq_lo/invalid: int32[N] or int32[B, N].  ovc_off: optional
    offset-value-code offsets vs the run predecessor
    (ops/ovc.run_ovc_offsets), of invalid's shape, carried through the
    sort for the kernel's code variant.  Outputs take invalid's shape;
    perm counts rows within each batch.

    The sort equals jax.lax.sort over (invalid, lanes..., seq_hi,
    seq_lo, iota) with is_stable=True (jax.vmap of it over B): 32-bit
    keys are joined in pairs into int64 keys, and validity is the most
    significant key, one 8-bit pass.  One winner-select launch serves
    all B batches (the kernel's lane stride)."""
    batched = invalid.dim() == 2
    if not batched:
        lanes, seq_hi, seq_lo, invalid = (
            lanes.unsqueeze(1), seq_hi.unsqueeze(0), seq_lo.unsqueeze(0),
            invalid.unsqueeze(0))
        ovc_off = None if ovc_off is None else ovc_off.unsqueeze(0)
    num_lanes, b, n = lanes.shape
    if num_key_lanes is None:
        num_key_lanes = num_lanes
    perm = _stable_argsort([invalid.to(torch.uint8)] + _lane_sort_keys(
        [lanes[i] for i in range(num_lanes)] + [seq_hi, seq_lo]))
    perm32 = perm.to(torch.int32)
    s_invalid = invalid.gather(-1, perm)
    s_lanes = lanes[:num_key_lanes].gather(
        -1, perm.unsqueeze(0).expand(num_key_lanes, b, n))
    s_off = ovc_off.gather(-1, perm) if ovc_off is not None else None
    eq_next = eq_next_mask(
        s_lanes.view(num_key_lanes, b * n), s_invalid.view(-1),
        ovc_off=None if s_off is None else s_off.view(-1),
        perm=None if s_off is None else perm32.view(-1),
        num_key_lanes=num_key_lanes, seg_len=n).view(b, n)
    eq_prev = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                     device=eq_next.device),
                         eq_next[:, :-1]], dim=1)
    valid = s_invalid == 0
    if keep == "last":
        winner = ~eq_next & valid
    else:  # "first"
        winner = ~eq_prev & valid
    # previous version of each winner: its predecessor within the same
    # segment, for changelog derivation
    prev_in_seg = torch.where(eq_prev, torch.roll(perm32, 1, dims=-1),
                              torch.full_like(perm32, -1))
    if not batched:
        return perm32[0], winner[0], prev_in_seg[0]
    return perm32, winner, prev_in_seg


def _merge_fn(lanes, seq_hi, seq_lo, invalid, keep: str,
              num_key_lanes: int, ovc_off=None):
    """Full variant: (perm, winner, prev) tensors."""
    return segmented_merge_body(lanes, seq_hi, seq_lo, invalid, keep,
                                num_key_lanes=num_key_lanes,
                                ovc_off=ovc_off)


def _merge_fn_packed(lanes, seq_hi, seq_lo, invalid, keep: str,
                     num_key_lanes: int) -> torch.Tensor:
    """Winners-only variant: ONE int32[N] word per row, perm in the low
    31 bits and the winner flag in bit 31 (the reference's uint32 word,
    as an int32 bit pattern)."""
    perm, winner, _ = segmented_merge_body(lanes, seq_hi, seq_lo, invalid,
                                           keep,
                                           num_key_lanes=num_key_lanes)
    return perm | torch.where(winner, _INT32_MIN, 0).to(torch.int32)


def _merge_fn_bitmask(lanes, seq_hi, seq_lo, invalid, keep: str,
                      num_key_lanes: int) -> torch.Tensor:
    """Winner BITMASK variant: uint8[M/8], one bit a row, the winner
    flags scattered back to the original row order (little-endian bit
    order, as np.unpackbits(..., bitorder="little") reads it): 1/32nd
    of the packed return."""
    perm, winner, _ = segmented_merge_body(lanes, seq_hi, seq_lo, invalid,
                                           keep,
                                           num_key_lanes=num_key_lanes)
    w_orig = torch.zeros_like(winner)
    w_orig[perm.long()] = winner
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.int32,
                           device=winner.device)
    return (w_orig.view(-1, 8).to(torch.int32) * weights).sum(
        dim=1, dtype=torch.int32).to(torch.uint8)


def _split_i64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 halves of an int64 tensor, as bit patterns."""
    halves = x.contiguous().view(torch.int32).view(-1, 2)
    return halves[:, 1], halves[:, 0]       # little-endian


def _writable(a, dtype) -> np.ndarray:
    """Contiguous, writable array for torch.from_numpy (Arrow-backed
    numpy views are read-only; torch warns on those)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return a if a.flags.writeable else a.copy()


def _upload(lanes, seq: np.ndarray, order_lanes, packed, dev):
    """Padded device inputs (lanes int32[L, M], seq_hi, seq_lo, invalid)
    of one merge; the packed u64 key is uploaded in place of the lane
    matrix when the key is one fixed-width column."""
    n, num_key_lanes = lanes.shape
    no_user_order = order_lanes is None or order_lanes.shape[1] == 0
    num_lanes = num_key_lanes + (0 if no_user_order
                                 else order_lanes.shape[1])
    m = _pad_size(n)
    lanes_p = torch.zeros((num_lanes, m), dtype=torch.int32, device=dev)
    if n:
        if packed is not None and no_user_order and num_key_lanes == 2:
            p = torch.from_numpy(_writable(packed, np.uint64)
                                 .view(np.int64)).to(dev)
            lanes_p[0, :n], lanes_p[1, :n] = _split_i64(p)
        else:
            mat = np.asarray(lanes)
            if not no_user_order:
                mat = np.concatenate([mat, order_lanes], axis=1)
            t = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint32)
                                 .view(np.int32)).to(dev)
            lanes_p[:, :n] = t.T
    seq_t = torch.zeros(m, dtype=torch.int64, device=dev)
    seq_t[:n] = torch.from_numpy(_writable(seq, np.int64))
    seq_hi, seq_lo = _split_i64(seq_t)
    invalid = torch.ones(m, dtype=torch.int32, device=dev)
    invalid[:n] = 0
    return lanes_p, seq_hi, seq_lo, invalid


# (host->device bytes/s, device->host bytes/s) of the card's link,
# measured once per process on the merge's own kind of transfer: the
# merge path choice hinges on exactly this number
_LINK_BW: Optional[Tuple[float, float]] = None

# merges taken per route this process: "device" counts every merge run
# on the device (full, packed and bitmask returns), "bitmask" the
# bitmask returns among them, "host" the host sorts and "ovc" the host
# offset-value-coded merges
PATH_COUNTS = {"host": 0, "device": 0, "ovc": 0, "bitmask": 0}
# merge workers run concurrently: the routing state's updates take it
_STATE_LOCK = threading.Lock()


def _count_route(*keys: str) -> None:
    with _STATE_LOCK:
        for key in keys:
            PATH_COUNTS[key] += 1

# cost-model constants (rows/s), measured by chip_smoke.py's
# merge_routes (measure_constants) on one NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit and the CPU of its host: the device rate is the
# stable sort passes plus the winner-select kernel on resident data
# (2 lanes, 2^24 rows), the host rates are the C radix fast route, the
# numpy argsort fast route and the general lexsort route at 2^22 rows,
# each the best of 3
_DEVICE_SORT_ROWS_PER_SEC = 2.69e9
_HOST_FAST_NUMPY_ROWS_PER_SEC = 11.1e6
_HOST_FAST_NATIVE_ROWS_PER_SEC = 18.1e6
_HOST_GENERAL_ROWS_PER_SEC = 10.2e6


def _host_fast_rate() -> float:
    # predict without triggering the C build: compiling inside the
    # routing decision would stall first merges on processes that
    # always route to the device
    return (_HOST_FAST_NATIVE_ROWS_PER_SEC
            if native.predicted_available()
            else _HOST_FAST_NUMPY_ROWS_PER_SEC)


def link_bandwidth(dev, size: int = 8 << 20,
                   rounds: int = 2) -> Tuple[float, float]:
    """(h2d, d2h) bytes/s of pageable host memory to and from `dev` (a
    CUDA device), best of `rounds` after one unmeasured warm-up round:
    the very first transfers absorb allocator and CUDA context warm-up."""
    buf = np.zeros(size, np.uint8)
    torch.from_numpy(buf).to(dev).cpu()
    torch.cuda.synchronize(dev)
    h2d = d2h = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        d = torch.from_numpy(buf).to(dev)
        torch.cuda.synchronize(dev)
        h2d = max(h2d, size / max(time.perf_counter() - t0, 1e-9))
        t0 = time.perf_counter()
        d.cpu()
        d2h = max(d2h, size / max(time.perf_counter() - t0, 1e-9))
    return h2d, d2h


def _measure_link_bandwidth(dev) -> Tuple[float, float]:
    global _LINK_BW
    if _LINK_BW is None:
        _LINK_BW = link_bandwidth(dev)
    return _LINK_BW


def _device_path_pays(n: int, num_lanes: int, winners_only: bool,
                      host_fast: bool, dev=None) -> bool:
    """Cost model: offload the sort only when transfer+compute beats
    the host sort."""
    m = _pad_size(n)
    h2d, d2h = _measure_link_bandwidth(dev)
    bytes_in = m * (4 * num_lanes + 12)          # lanes + seq hi/lo + inv
    bytes_out = m * (4 if winners_only else 9)   # packed vs perm+win+prev
    t_dev = bytes_in / h2d + bytes_out / d2h + m / _DEVICE_SORT_ROWS_PER_SEC
    host_rate = _host_fast_rate() if host_fast \
        else _HOST_GENERAL_ROWS_PER_SEC
    return t_dev < n / host_rate


# measured winner fraction of recent merges (the duplicate-ratio
# estimate of the bitmask cost model); starts at the conservative 1.0
# (no dedup benefit assumed until observed).  Only the native fused
# host route and the bitmask route update it.
_WINNER_FRAC = {"num": 0.0, "den": 0.0}


def _observe_winners(winners: int, rows: int) -> None:
    with _STATE_LOCK:
        _WINNER_FRAC["num"] += float(winners)
        _WINNER_FRAC["den"] += float(rows)


def _observed_winner_frac() -> float:
    if _WINNER_FRAC["den"] < 1.0:
        return 1.0
    return max(0.05, _WINNER_FRAC["num"] / _WINNER_FRAC["den"])


def _bitmask_device_pays(n: int, num_lanes: int, overlapped: bool,
                         dev=None) -> bool:
    """Cost model for the bitmask return: the device sorts and dedups,
    the host re-sorts only the winners.  With `overlapped=True` the
    caller runs merges on a pipeline worker, so upload, sort and
    download hide under the next window's decode and cut; only the
    host epilogue stays on the merge's critical path."""
    m = _pad_size(n)
    h2d, d2h = _measure_link_bandwidth(dev)
    host_rate = _host_fast_rate()
    frac = _observed_winner_frac()
    t_link = (m * (4 * num_lanes + 12)) / h2d \
        + m / _DEVICE_SORT_ROWS_PER_SEC + (m / 8) / d2h
    t_epilogue = frac * n / host_rate      # radix of winners only
    t_dev = t_epilogue + (0.0 if overlapped else t_link)
    # even overlapped, the link must keep up with the pipeline or the
    # worker stalls: charge any link time beyond the host-path budget
    if overlapped:
        budget = n / host_rate
        t_dev += max(0.0, t_link - budget)
    return t_dev < n / host_rate


def _host_sorted_winners_fast(lanes, seq: np.ndarray, keep: str,
                              packed: Optional[np.ndarray] = None
                              ) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Packed-key fast route for exactly two key lanes (a fixed-width
    64-bit key) and no changelog predecessor: one stable argsort of a
    u64 key, then the winner per segment by segmented max/min of (seq,
    arrival).  Winner = max seq (ties -> the later arrival) for
    keep=last, min seq (ties -> the earlier arrival) for keep=first.
    With the C library it is one fused radix sort and segment scan."""
    n = lanes.shape[0]
    if packed is not None:
        key = packed
    else:
        lanes = np.asarray(lanes)    # materialize if lazily concatenated
        key = (lanes[:, 0].astype(np.uint64) << np.uint64(32)) \
            | lanes[:, 1].astype(np.uint64)
    fused = native.merge_winners(key, seq, keep == "last")
    if fused is not None:
        perm, winner = fused
        _observe_winners(np.count_nonzero(winner), n)
        return perm, winner, np.broadcast_to(np.int64(-1), n)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    k_sorted = key[perm]
    starts_mask = np.empty(n, dtype=bool)
    starts_mask[0] = True
    starts_mask[1:] = k_sorted[1:] != k_sorted[:-1]
    seg_starts = np.flatnonzero(starts_mask)
    seg_id = np.cumsum(starts_mask) - 1
    seq_sorted = seq[perm]
    if keep == "last":
        best_seq = np.maximum.reduceat(seq_sorted, seg_starts)
        tie = seq_sorted == best_seq[seg_id]
        cand = np.where(tie, perm, -1)
        best_arrival = np.maximum.reduceat(cand, seg_starts)
    else:
        best_seq = np.minimum.reduceat(seq_sorted, seg_starts)
        tie = seq_sorted == best_seq[seg_id]
        cand = np.where(tie, perm, n)
        best_arrival = np.minimum.reduceat(cand, seg_starts)
    winner = tie & (perm == best_arrival[seg_id])
    # winners_only contract: prev is never read
    return perm, winner, np.broadcast_to(np.int64(-1), n)


def _winner_epilogue(perm: np.ndarray, eq_neighbors: np.ndarray,
                     keep: str) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Shared tail of every sorted-winner host route: `eq_neighbors[i]`
    says sorted rows i and i+1 share a key.  Winner = segment end
    (keep=last) or start (keep=first); prev = in-segment predecessor."""
    eq_next = np.concatenate([eq_neighbors, [False]])
    eq_prev = np.concatenate([[False], eq_neighbors])
    winner = ~eq_next if keep == "last" else ~eq_prev
    prev = np.where(eq_prev, np.roll(perm, 1), -1)
    return perm, winner, prev


def _host_sorted_winners(lanes, seq: np.ndarray, keep: str,
                         num_key_lanes: int, need_prev: bool = True,
                         packed: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host sort with exactly the kernel's semantics, unpadded."""
    n, num_lanes = lanes.shape
    if num_lanes == 2 and num_key_lanes == 2 and not need_prev and n > 0:
        return _host_sorted_winners_fast(lanes, seq, keep, packed=packed)
    if num_lanes == 2 and num_key_lanes == 2 and n > 0 \
            and packed is not None:
        # full-order variant of the packed fast route: two stable C
        # radix passes (by seq, then by key) compose to the exact
        # (key, seq, arrival) order of the lexsort
        if native.load() is not None and int(seq.min()) >= 0:
            useq = seq.astype(np.int64, copy=False).view(np.uint64)
            p1 = native.radix_argsort(useq)
            p2 = native.radix_argsort(np.ascontiguousarray(packed[p1])) \
                if p1 is not None else None
            if p2 is not None:
                perm = p1[p2].astype(np.int32, copy=False)
                k_sorted = packed[perm]
                return _winner_epilogue(perm, k_sorted[1:] == k_sorted[:-1],
                                        keep)
    lanes = np.asarray(lanes)        # materialize if lazily concatenated
    useq = seq.astype(np.int64, copy=False).view(np.uint64)
    keys = ((useq & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (useq >> np.uint64(32)).astype(np.uint32),
            *(lanes[:, i] for i in range(num_lanes - 1, -1, -1)))
    perm = np.lexsort(keys).astype(np.int32)
    s_lanes = lanes[:, :num_key_lanes][perm]
    eq = np.all(s_lanes[:-1] == s_lanes[1:], axis=1)
    return _winner_epilogue(perm, eq, keep)


def _bitmask_sorted_winners(lanes, seq: np.ndarray, keep: str,
                            order_lanes: Optional[np.ndarray],
                            packed: np.ndarray, dev
                            ) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]:
    """Device route with the N/8-byte return: upload the keys and seq,
    the device sorts and computes the winner mask in original row
    order, the host radix-sorts only the winners' packed keys to recover
    key order.  Returns (winner indices in key order, all-true, -1):
    valid under the winners_only contract."""
    _count_route("device", "bitmask")
    n = packed.shape[0]
    lanes_p, seq_hi, seq_lo, invalid = _upload(lanes, seq, order_lanes,
                                               packed, dev)
    mask_bytes = _merge_fn_bitmask(lanes_p, seq_hi, seq_lo, invalid, keep,
                                   2).cpu().numpy()
    mask = np.unpackbits(mask_bytes, bitorder="little")[:n].astype(bool)
    widx = np.flatnonzero(mask)           # winners, original row order
    _observe_winners(len(widx), n)
    wkeys = np.ascontiguousarray(packed[widx])
    perm_w = native.radix_argsort(wkeys)
    if perm_w is None:
        perm_w = np.argsort(wkeys, kind="stable")
    indices = widx[perm_w].astype(np.int32)
    return (indices, np.ones(len(indices), dtype=bool),
            np.broadcast_to(np.int64(-1), len(indices)))


def device_sorted_winners(lanes, seq: np.ndarray, keep: str = "last",
                          order_lanes: Optional[np.ndarray] = None,
                          winners_only: bool = False,
                          packed: Optional[np.ndarray] = None,
                          overlapped: bool = False,
                          run_starts: Optional[np.ndarray] = None,
                          device=None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted winners of a merge, on `device` (None = cuda) or the host.

    lanes: uint32[N, L] (segment identity; may be a lazy view);
    seq: int64[N] (non-negative); order_lanes: optional uint32[N, O]
    user-defined sequence lanes that rank within a key BEFORE the
    internal sequence.  `winners_only=True` promises the caller reads
    only the winner rows, which admits the packed and bitmask returns
    and the host fast route.  `packed`: the encoder's u64 key when the
    key is one fixed-width column.  `overlapped`: the caller runs merges
    on a pipeline worker (the bitmask cost model).  `run_starts`:
    int64[k+1] boundaries of k (key, seq)-sorted input runs; the device
    full variant feeds their offset-value codes to the kernel's code
    variant, the host route merges them (ops/ovc.py).

    Returns numpy (perm, winner_mask, prev_in_segment): of the
    power-of-two padded size on the device routes, UNPADDED (length N,
    all rows valid) on the host routes, and winners only (all-true
    mask) on the bitmask route.  Callers select through the winner mask
    and `perm < n`, never assume a padded length.

    Route: on a CUDA device the first call measures the link, and each
    merge takes the bitmask return where `_bitmask_device_pays`, else
    the device where `_device_path_pays`, else the host; on the CPU the
    device routes stay.  PAIMON_FORCE_DEVICE_SORT=1 pins the device
    routes, PAIMON_FORCE_HOST_SORT=1 the host routes and
    PAIMON_FORCE_BITMASK_SORT=1 the bitmask return where the caller
    admits it."""
    dev = resolve_device(device)
    n, num_key_lanes = lanes.shape
    force_device = os.environ.get("PAIMON_FORCE_DEVICE_SORT") == "1"
    force_bitmask = os.environ.get("PAIMON_FORCE_BITMASK_SORT") == "1"
    force_host = os.environ.get("PAIMON_FORCE_HOST_SORT") == "1"
    no_user_order = order_lanes is None or order_lanes.shape[1] == 0
    host_fast = num_key_lanes == 2 and winners_only and no_user_order
    # bitmask return: winners-only callers with a pre-packed u64 key
    bitmask_ok = winners_only and packed is not None and n > 0
    nl_total = lanes.shape[1] + (0 if no_user_order
                                 else order_lanes.shape[1])
    use_bitmask = force_bitmask and bitmask_ok
    use_host = force_host
    if not use_host and not force_device and not force_bitmask and n > 0 \
            and dev.type == "cuda":
        use_bitmask = bitmask_ok and _bitmask_device_pays(
            n, nl_total, overlapped, dev)
        if not use_bitmask:
            use_host = not _device_path_pays(n, nl_total, winners_only,
                                             host_fast, dev)
    if use_bitmask:
        return _bitmask_sorted_winners(lanes, seq, keep, order_lanes,
                                       np.asarray(packed), dev)
    if use_host:
        if run_starts is not None and no_user_order and len(run_starts) > 1:
            # sorted-run inputs: the offset-value-coded merge replaces
            # the sort
            from paimon_tpu_torch.ops.ovc import ovc_sorted_winners
            res = ovc_sorted_winners(lanes, seq, keep, run_starts,
                                     num_key_lanes, packed=packed)
            if res is not None:
                _count_route("ovc")
                return res
        _count_route("host")
        full = lanes if no_user_order \
            else np.concatenate([np.asarray(lanes), order_lanes], axis=1)
        return _host_sorted_winners(full, seq, keep, num_key_lanes,
                                    need_prev=not winners_only,
                                    packed=packed if no_user_order
                                    else None)
    _count_route("device")
    lanes_p, seq_hi, seq_lo, invalid = _upload(lanes, seq, order_lanes,
                                               packed, dev)
    m = lanes_p.shape[1]
    if winners_only:
        word = _merge_fn_packed(lanes_p, seq_hi, seq_lo, invalid, keep,
                                num_key_lanes)
        w = word.cpu().numpy().view(np.uint32)
        perm = (w & np.uint32(0x7FFFFFFF)).astype(np.int32)
        winner = (w >> np.uint32(31)).astype(bool)
        return perm, winner, np.broadcast_to(np.int32(-1), m)
    ovc_t = None
    if run_starts is not None:
        from paimon_tpu_torch.ops.ovc import OVC_OFF_SENTINEL, run_ovc_offsets
        off = np.full(m, OVC_OFF_SENTINEL, dtype=np.uint32)
        off[:n] = run_ovc_offsets(lanes, run_starts)
        ovc_t = torch.from_numpy(off.view(np.int32)).to(dev)
    perm, winner, prev = _merge_fn(lanes_p, seq_hi, seq_lo, invalid, keep,
                                   num_key_lanes, ovc_off=ovc_t)
    return perm.cpu().numpy(), winner.cpu().numpy(), prev.cpu().numpy()


def user_seq_order_lanes(table: pa.Table,
                         seq_fields: Sequence[str],
                         descending: bool = False) -> np.ndarray:
    """uint32[N, O] order lanes for user-defined sequence columns
    (reference utils/UserDefinedSeqComparator). Nulls rank FIRST — a row
    with a null sequence always loses to any non-null one (in either
    sort order).  `descending` implements
    sequence.field.sort-order=descending: the SMALLER user sequence
    wins, via bitwise inversion of the value lanes."""
    for f in seq_fields:
        t = table.schema.field(f).type
        if pa.types.is_string(t) or pa.types.is_large_string(t) or \
                pa.types.is_binary(t) or pa.types.is_large_binary(t):
            raise ValueError(
                f"sequence.field {f!r} must be numeric/temporal; string "
                f"sequences would compare only by a fixed-width prefix")
    enc = NormalizedKeyEncoder(
        [table.schema.field(f).type for f in seq_fields],
        nullable=[True] * len(seq_fields))
    lanes, _ = enc.encode_table(table, seq_fields)
    pos = 0
    for nl in enc.lanes_per_col:
        # encoder presence lane sorts nulls last; sequences need the
        # opposite (null = smallest, so null always loses)
        lanes[:, pos] = 1 - lanes[:, pos]
        if descending:
            for p in range(pos + 1, pos + nl):
                lanes[:, p] = np.uint32(0xFFFFFFFF) - lanes[:, p]
        pos += nl
    return lanes


def sort_table(table: pa.Table, key_names: Sequence[str],
               key_encoder: Optional[NormalizedKeyEncoder] = None,
               device=None) -> np.ndarray:
    """Full sort permutation by (key, seq). Returns indices into `table`
    in sorted order (stable: arrival order for ties)."""
    n = table.num_rows
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if key_encoder is None:
        key_encoder = NormalizedKeyEncoder(
            [table.schema.field(k).type for k in key_names],
            nullable=[table.schema.field(k).nullable for k in key_names])
    lanes, truncated = key_encoder.encode_table(table, key_names)
    seq = np.asarray(table.column(SEQ_COL).combine_chunks().cast(pa.int64()))
    perm, _, _ = device_sorted_winners(lanes, seq, "last", device=device)
    order = perm[perm < n].astype(np.int64)
    if truncated.any():
        # prefix ties may misorder full keys; host re-sort of affected rows
        key_cols = [table.column(k) for k in key_names]

        def full_key(i):
            return tuple(c[int(i)].as_py() for c in key_cols)

        order = np.array(
            sorted(order.tolist(),
                   key=lambda i: (full_key(i), int(seq[i]))),
            dtype=np.int64)
    return order


class _LazyLanes:
    """Deferred np.concatenate of per-run lane matrices: the packed-key
    upload never reads the lane matrix, so the 8N-byte copy per window
    is usually skipped.  Exposes .shape; np.asarray(...) materializes
    with a one-shot cache."""

    def __init__(self, parts: List[np.ndarray]):
        self._parts = parts
        n = sum(p.shape[0] for p in parts)
        self.shape = (n, parts[0].shape[1] if parts else 0)
        self._mat: Optional[np.ndarray] = None

    def __array__(self, dtype=None, copy=None):
        if self._mat is None:
            self._mat = (np.concatenate([np.asarray(p) for p in self._parts])
                         if len(self._parts) > 1
                         else np.asarray(self._parts[0]))
        out = self._mat if dtype is None else self._mat.astype(dtype)
        if copy and out is self._mat:
            out = out.copy()
        return out


def merge_runs(runs: Sequence[pa.Table], key_names: Sequence[str],
               merge_engine: str = "deduplicate",
               drop_deletes: bool = True,
               key_encoder: Optional[NormalizedKeyEncoder] = None,
               with_prev: bool = False,
               seq_fields: Optional[Sequence[str]] = None,
               seq_desc: bool = False,
               encoded: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]]
               = None,
               overlapped: bool = False,
               device=None) -> MergeResult:
    """Merge k sorted runs (oldest first) into the latest row per key
    (deduplicate) or the first (first-row), on `device`.  `overlapped`:
    the caller runs merges on a pipeline worker (device_sorted_winners'
    bitmask cost model).

    Equivalent reference path: MergeTreeReaders.readerForMergeTree
    (mergetree/MergeTreeReaders.java:44) + DeduplicateMergeFunction /
    FirstRowMergeFunction + DropDeleteReader.
    """
    if not runs:
        raise ValueError("No runs to merge")
    if merge_engine not in ("deduplicate", "first-row"):
        raise NotImplementedError(
            f"merge_runs folds deduplicate and first-row only; "
            f"merge-engine {merge_engine!r} merges through "
            f"ops.agg.merge_runs_agg")
    table = pa.concat_tables(runs, promote_options="none")
    n = table.num_rows
    if n == 0:
        return MergeResult(table, np.zeros(0, dtype=np.int64))

    if key_encoder is None:
        key_encoder = NormalizedKeyEncoder(
            [table.schema.field(k).type for k in key_names],
            nullable=[table.schema.field(k).nullable for k in key_names])
    packed = None
    if encoded is not None:
        # caller already lane-encoded each run (streamed windows encode
        # once for the window cut); items are (lanes, truncated[, packed])
        truncated = (np.concatenate([e[1] for e in encoded])
                     if len(encoded) > 1 else np.asarray(encoded[0][1]))
        packs = [e[2] if len(e) > 2 else None for e in encoded]
        if all(p is not None for p in packs):
            packed = (np.concatenate(packs) if len(packs) > 1
                      else np.asarray(packs[0]))
        lanes = _LazyLanes([e[0] for e in encoded])
        run_lens = [e[0].shape[0] for e in encoded]
    else:
        lanes, truncated, packed = key_encoder.encode_table_ex(
            table, key_names)
        run_lens = [r.num_rows for r in runs]
    seq = np.asarray(table.column(SEQ_COL).combine_chunks().cast(pa.int64()))
    # sorted-run boundaries for the kernel's offset-value-code variant:
    # every input run (or window chunk of one) is (key, seq)-sorted
    run_starts = np.concatenate([[0], np.cumsum(run_lens)]).astype(np.int64)

    keep = "first" if merge_engine == "first-row" else "last"
    if seq_fields and keep == "first":
        raise ValueError(
            "sequence.field cannot be used with merge-engine first-row")
    order_lanes = user_seq_order_lanes(table, seq_fields, seq_desc) \
        if seq_fields else None
    # without changelog derivation the caller consumes only winner rows
    # — unless a key was prefix-truncated: _refine_truncated needs the
    # full variant's seq-ordered segments
    perm, winner, prev = device_sorted_winners(
        lanes, seq, keep, order_lanes,
        winners_only=not with_prev and not truncated.any(),
        packed=packed, overlapped=overlapped,
        run_starts=run_starts if order_lanes is None else None,
        device=device)

    win_pos = np.flatnonzero(winner)
    indices = perm[win_pos].astype(np.int64)
    prev_idx = prev[win_pos].astype(np.int64) if with_prev else None

    if truncated.any():
        indices, prev_idx = _refine_truncated(
            table, key_names, perm, winner, truncated, seq, keep,
            with_prev, prev)

    if drop_deletes and KIND_COL in table.column_names:
        # a uniformly +I or +U batch (min == max in {0, 2}) has no -U/-D
        import pyarrow.compute as pc
        mm = pc.min_max(table.column(KIND_COL))
        lo, hi = mm["min"].as_py(), mm["max"].as_py()
        if not (lo == hi and lo in (RowKind.INSERT,
                                    RowKind.UPDATE_AFTER)):
            kinds = np.asarray(table.column(KIND_COL).combine_chunks()
                               .cast(pa.int8()))
            keep_mask = (kinds[indices] == RowKind.INSERT) | \
                        (kinds[indices] == RowKind.UPDATE_AFTER)
            indices = indices[keep_mask]
            if prev_idx is not None:
                prev_idx = prev_idx[keep_mask]

    return MergeResult(table, indices, prev_idx)


def _refine_truncated(table: pa.Table, key_names, perm, winner, truncated,
                      seq, keep: str, with_prev: bool, prev=None):
    """Host fix-up for prefix-truncated string keys: rows whose prefix
    collided may belong to different real keys, so device segments can
    over-group. Only the sorted spans that contain a truncated row are
    re-grouped by full key on the host; all other winners keep the device
    result. Rare path (keys longer than the prefix sharing a prefix)."""
    n = len(seq)
    winner = np.asarray(winner)
    sorted_real_mask = perm < n
    sorted_real = perm[sorted_real_mask]              # sorted positions
    win_sorted = winner[sorted_real_mask]
    s_trunc = truncated[sorted_real]

    m = len(sorted_real)
    if keep == "last":
        seg_end = win_sorted.copy()
        seg_end[-1] = True
        seg_id = np.concatenate([[0], np.cumsum(seg_end[:-1])])
    else:
        seg_start = win_sorted.copy()
        seg_start[0] = True
        seg_id = np.cumsum(seg_start) - 1

    # spans affected by truncation
    affected_segs = set(np.unique(seg_id[s_trunc]).tolist())
    if not affected_segs:
        win_pos = np.flatnonzero(winner)
        prev_idx = (np.asarray(prev)[win_pos].astype(np.int64)
                    if with_prev and prev is not None else None)
        return (perm[win_pos].astype(np.int64), prev_idx)

    key_cols = [table.column(k) for k in key_names]

    def full_key(i: int):
        return tuple(c[int(i)].as_py() for c in key_cols)

    idx_out: List[int] = []
    prev_out: List[int] = []
    i = 0
    while i < m:
        sid = seg_id[i]
        j = i
        while j < m and seg_id[j] == sid:
            j += 1
        span = sorted_real[i:j]
        if sid not in affected_segs:
            for p, w in zip(span, win_sorted[i:j]):
                if w:
                    idx_out.append(int(p))
                    if with_prev:
                        pos = list(span).index(p)
                        prev_out.append(int(span[pos - 1]) if pos > 0 else -1)
        else:
            # re-group by full key; span order is (prefix, seq) so within a
            # real key rows remain seq-ordered
            groups: dict = {}
            for p in span:
                groups.setdefault(full_key(p), []).append(int(p))
            for k in sorted(groups):
                g = groups[k]
                if keep == "last":
                    idx_out.append(g[-1])
                    prev_out.append(g[-2] if len(g) > 1 else -1)
                else:
                    idx_out.append(g[0])
                    prev_out.append(-1)
        i = j
    return (np.array(idx_out, dtype=np.int64),
            np.array(prev_out, dtype=np.int64) if with_prev else None)
