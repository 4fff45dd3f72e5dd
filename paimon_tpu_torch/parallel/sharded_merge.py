"""Multi-bucket merge over a mesh of bucket lanes.

Counterpart of paimon_tpu/parallel/sharded_merge.py.  Buckets are the
unit of parallelism (the reference shuffles rows to bucket tasks via
table/sink/ChannelComputer; each task merges one bucket with a loser
tree).  The reference stacks every bucket into [B, N] arrays, shards
the bucket axis over a jax Mesh and runs the per-bucket segmented
sort-merge vmapped on each device, with row counts summed by `psum`.

Here a mesh (`BucketMesh`) is a number of lanes, the reference mesh's
devices.  In one process every lane is a row of one batch on one torch
device: the stable sort runs per row along the last dimension and ONE
winner-select launch covers all rows (ops/merge.segmented_merge_body
over [B, N]).  Over a torch.distributed group of W ranks each rank
holds n_lanes / W lanes; `psum` is the sum over the local lanes plus
`all_reduce`, and results come back to every rank by `all_gather`, so
each rank returns what one process returns.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from paimon_tpu_torch.device import resolve_device

__all__ = ["BucketMesh", "bucket_mesh", "pad_bucket_batches",
           "ShardedBucketMerge", "merge_buckets_sharded"]


class BucketMesh:
    """`n_lanes` bucket lanes on `device`, split evenly over the ranks
    of `group` (None: one process)."""

    def __init__(self, n_lanes: int, device: torch.device, group=None):
        import torch.distributed as dist

        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if n_lanes < 1 or n_lanes % self.world:
            raise ValueError(f"{n_lanes} lanes do not split over "
                             f"{self.world} ranks")
        self.n_lanes = n_lanes
        self.device = device

    def local(self, a):
        """This rank's rows of a [B, ...] stack (B a multiple of the
        world size): the buckets its lanes hold."""
        per = a.shape[0] // self.world
        return a[self.rank * per:(self.rank + 1) * per]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' `t` (already reduced over local lanes)."""
        if self.world > 1:
            import torch.distributed as dist
            t = t.clone()
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' [b, ...] blocks stacked in rank order."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        # gloo gathers no bool tensors: bytes travel instead
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire.contiguous(), group=self.group)
        return torch.cat(parts).to(t.dtype)

    def __repr__(self):
        return (f"BucketMesh({self.n_lanes} lanes on {self.device}, "
                f"{self.world} ranks)")


def bucket_mesh(n_lanes: Optional[int] = None, device=None,
                group=None) -> BucketMesh:
    """A mesh of `n_lanes` bucket lanes (None: the world size, so one
    lane on one card, as the reference's mesh over one device) on
    `device` (None: cuda).  `group`: a torch.distributed process group;
    None takes the default group when one is initialised."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    return BucketMesh(world if n_lanes is None else int(n_lanes),
                      resolve_device(device), group)


def pad_bucket_batches(
    lanes_list: Sequence[np.ndarray], seq_list: Sequence[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-bucket (lanes uint32[N_b, L], seq int64[N_b]) into padded
    [B, N, ...] arrays with an invalid mask (padding sorts last)."""
    from paimon_tpu_torch.ops.merge import _pad_size

    b = len(lanes_list)
    num_lanes = lanes_list[0].shape[1] if b else 0
    # the row axis pads to a power of two, as the reference's (which
    # reuses compiled programs across nearby sizes)
    n = _pad_size(max((len(s) for s in seq_list), default=0))
    lanes = np.zeros((b, n, num_lanes), dtype=np.uint32)
    seq_hi = np.zeros((b, n), dtype=np.uint32)
    seq_lo = np.zeros((b, n), dtype=np.uint32)
    invalid = np.ones((b, n), dtype=np.uint32)
    for i, (la, sq) in enumerate(zip(lanes_list, seq_list)):
        k = len(sq)
        lanes[i, :k] = la
        u = sq.astype(np.int64).view(np.uint64)
        seq_hi[i, :k] = (u >> np.uint64(32)).astype(np.uint32)
        seq_lo[i, :k] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        invalid[i, :k] = 0
    return lanes, seq_hi, seq_lo, invalid


def pad_lanes(mesh: BucketMesh, *arrays, fills=None):
    """Pad each [B, ...] array to a multiple of the mesh's lanes with
    `fills` (default 0) rows; returns (B, padded arrays)."""
    b = arrays[0].shape[0]
    pad = (-b) % mesh.n_lanes
    fills = fills or [0] * len(arrays)
    if not pad:
        return b, list(arrays)
    return b, [np.concatenate([a, np.full((pad,) + a.shape[1:], f, a.dtype)])
               for a, f in zip(arrays, fills)]


def _upload(mesh: BucketMesh, a: np.ndarray) -> torch.Tensor:
    """This rank's rows of a uint32 [B, ...] array, as int32 bit
    patterns on the mesh's device."""
    local = np.ascontiguousarray(mesh.local(a)).view(np.int32)
    return torch.from_numpy(local).to(mesh.device)


def device_merge(mesh: BucketMesh, lanes: np.ndarray, seq_hi: np.ndarray,
                 seq_lo: np.ndarray, invalid: np.ndarray, keep: str,
                 num_key_lanes: Optional[int] = None,
                 ovc_off: Optional[np.ndarray] = None):
    """This rank's lanes of one mesh step: uint32 lanes[B, N, L] and
    seq_hi/seq_lo/invalid/ovc_off[B, N] (B a multiple of the lane count)
    in, the batched segmented merge's (perm, winner) [b, N] tensors out,
    on the mesh's device."""
    from paimon_tpu_torch.ops.merge import segmented_merge_body

    lanes_t = _upload(mesh, lanes).permute(2, 0, 1).contiguous()
    perm, winner, _ = segmented_merge_body(
        lanes_t, _upload(mesh, seq_hi), _upload(mesh, seq_lo),
        _upload(mesh, invalid), keep, num_key_lanes=num_key_lanes,
        ovc_off=None if ovc_off is None else _upload(mesh, ovc_off))
    return perm, winner


class ShardedBucketMerge:
    """Batched merge over a mesh.

    __call__(lanes[B,N,L], seq_hi[B,N], seq_lo[B,N], invalid[B,N]) ->
    (perm[B,N] int32, winner[B,N] bool, total_rows int summed over the
    mesh); B pads to a multiple of the mesh's lanes."""

    def __init__(self, mesh: BucketMesh, keep: str = "last"):
        self.mesh = mesh
        self.keep = keep

    def __call__(self, lanes: np.ndarray, seq_hi: np.ndarray,
                 seq_lo: np.ndarray, invalid: np.ndarray):
        b, (lanes, seq_hi, seq_lo, invalid) = pad_lanes(
            self.mesh, lanes, seq_hi, seq_lo, invalid, fills=[0, 0, 0, 1])
        perm, winner = device_merge(self.mesh, lanes, seq_hi, seq_lo,
                                    invalid, self.keep)
        total = self.mesh.psum(winner.sum(dtype=torch.int64))
        perm, winner = self.mesh.gather(perm), self.mesh.gather(winner)
        return (perm.cpu().numpy()[:b], winner.cpu().numpy()[:b],
                int(total))


def merge_buckets_sharded(
    lanes_list: Sequence[np.ndarray], seq_list: Sequence[np.ndarray],
    mesh: Optional[BucketMesh] = None, keep: str = "last"
) -> Tuple[List[np.ndarray], int]:
    """Merge many buckets at once over a mesh.

    Bucket b has key lanes uint32[N_b, L] and sequence int64[N_b] (rows
    in arrival order, runs concatenated oldest-first).  Returns each
    bucket's winner indices (into its input order, sorted by key) and
    the total output row count summed over the mesh."""
    if not lanes_list:
        return [], 0
    if mesh is None:
        mesh = bucket_mesh()
    lanes, seq_hi, seq_lo, invalid = pad_bucket_batches(lanes_list, seq_list)
    perm, winner, total = ShardedBucketMerge(
        mesh, keep=keep)(lanes, seq_hi, seq_lo, invalid)
    return ([perm[i][np.flatnonzero(winner[i])].astype(np.int64)
             for i in range(len(lanes_list))], total)
