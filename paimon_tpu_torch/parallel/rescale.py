"""Bucket rescale through an all_to_all repartition.

Counterpart of paimon_tpu/parallel/rescale.py.  Changing a table's
bucket count re-hashes every row to `Math.abs(hash % newBuckets)` and
moves it to its new owner (reference table/sink/ChannelComputer.java
routing).  Each lane of the mesh takes an equal slice of the table's
row-hash vector, computes every row's new bucket on the device (Java's
truncated remainder, bit-equal to core/bucket._bucket_from_hash),
packs row references into one fixed-capacity slot block per target
lane (owner: new_bucket % lanes), and one all_to_all delivers each lane
the references it owns: in one process a transpose of the [source,
target, slot] block, over a torch.distributed group
`all_to_all_single`.  Row bytes never reach the device: the host moves
Arrow rows by the routing, writes the new bucket files and commits an
overwrite.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["rescale_dispatch_sharded", "rescale_table_buckets",
           "rescale_routing", "rescale_write_messages", "rescale_commit"]

_INVALID = -1


def _dispatch_kernel(mesh, hashes: torch.Tensor, valid: torch.Tensor,
                     gid: torch.Tensor, cap: int, new_buckets: int):
    """This rank's source lanes [b, n] of (hash bits as int32, valid,
    global row id) -> (the [target lane, source lane, cap] blocks of row
    ids and new buckets every target lane received, gathered from all
    ranks; rows that did not fit, summed over the mesh)."""
    n_lanes = mesh.n_lanes
    b, n_per = hashes.shape
    dev = hashes.device
    # Java `Math.abs(h % n)`: fmod truncates toward zero, as Java's %;
    # its magnitude is below n, so abs cannot overflow (INT32_MIN too)
    new_bucket = torch.fmod(hashes, new_buckets).abs().to(torch.int64)
    target = torch.where(valid, new_bucket % n_lanes,
                         torch.full_like(new_bucket, n_lanes))
    # contiguous per-target runs through one stable sort per lane
    order = torch.sort(target, dim=-1, stable=True).indices
    s_target = target.gather(-1, order)
    s_gid = gid.gather(-1, order)
    s_bucket = new_bucket.gather(-1, order)
    lanes_ix = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(s_target,
                                lanes_ix.expand(b, n_lanes).contiguous())
    idx_in_run = torch.arange(n_per, dtype=torch.int64, device=dev) - \
        starts.gather(-1, s_target.clamp(max=n_lanes - 1))
    routed = s_target < n_lanes
    ok = routed & (idx_in_run < cap)
    # rows that do not fit go to an extra slot row that is sliced off:
    # an in-range dummy slot would race the genuine row written there
    # (scatter order is unspecified)
    rows = torch.where(ok, s_target, torch.full_like(s_target, n_lanes))
    cols = torch.where(ok, idx_in_run, torch.zeros_like(idx_in_run))
    src = torch.arange(b, dtype=torch.int64, device=dev).unsqueeze(1)
    flat = (src * (n_lanes + 1) + rows) * cap + cols
    blocks = []
    for values in (s_gid, s_bucket):
        slot = torch.full((b * (n_lanes + 1) * cap,), _INVALID,
                          dtype=torch.int64, device=dev)
        slot.scatter_(0, flat.view(-1), values.reshape(-1))
        blocks.append(slot.view(b, n_lanes + 1, cap)[:, :n_lanes])
    dropped = mesh.psum((routed & ~ok).sum(dtype=torch.int64))
    return [_all_to_all(mesh, blk) for blk in blocks], int(dropped)


def _all_to_all(mesh, block: torch.Tensor) -> torch.Tensor:
    """[source lane (this rank's), target lane, cap] -> [target lane,
    source lane, cap] over every lane of the mesh, on every rank."""
    if mesh.world == 1:
        return block.transpose(0, 1)
    import torch.distributed as dist
    b, n_lanes, cap = block.shape
    per = n_lanes // mesh.world
    # target rank r gets this rank's blocks for the lanes it owns
    send = block.view(b, mesh.world, per, cap).permute(1, 0, 2, 3) \
        .contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    # recv: [source rank, its lanes, my target lanes, cap]
    mine = recv.view(n_lanes, per, cap).transpose(0, 1).contiguous()
    return mesh.gather(mine)


def rescale_dispatch_sharded(hashes: np.ndarray, new_buckets: int,
                             mesh=None, slack: float = 2.0
                             ) -> Dict[int, np.ndarray]:
    """Route every row to its new bucket with one all_to_all.

    hashes: uint32[total_rows] reference-compatible bucket hashes in
    global row order (core/bucket.KeyHasher.hashes, low 32 bits).
    Returns {new_bucket: sorted global row indices} covering every row.
    The slot capacity grows and the dispatch reruns when hash skew
    overflows it."""
    from paimon_tpu_torch.parallel.sharded_merge import bucket_mesh

    if mesh is None:
        mesh = bucket_mesh()
    n_lanes = mesh.n_lanes
    total = len(hashes)
    n_per = max(1, -(-total // n_lanes))
    # a balanced (source, target) block holds n_per / n_lanes rows; the
    # worst case (every local row to one target) n_per
    cap = min(n_per, max(16, int(n_per / n_lanes * slack)))
    padded = n_per * n_lanes
    h = np.zeros(padded, dtype=np.uint32)
    h[:total] = hashes.astype(np.uint32)
    valid = np.zeros(padded, dtype=bool)
    valid[:total] = True

    def local(a):
        return torch.from_numpy(np.ascontiguousarray(
            mesh.local(a.reshape(n_lanes, n_per)))).to(mesh.device)

    (recv_gid, recv_bkt), dropped = _dispatch_kernel(
        mesh, local(h.view(np.int32)), local(valid),
        local(np.arange(padded, dtype=np.int64)), cap, new_buckets)
    if dropped > 0:
        if cap >= n_per:
            raise RuntimeError("rescale slot capacity overflow")
        return rescale_dispatch_sharded(hashes, new_buckets, mesh,
                                        slack * 4)

    gids = recv_gid.reshape(-1).cpu().numpy()
    bkts = recv_bkt.reshape(-1).cpu().numpy()
    ok = gids != _INVALID
    gids, bkts = gids[ok], bkts[ok]
    order = np.argsort(bkts, kind="stable")
    bkts_s, gids_s = bkts[order], gids[order]
    uniq, starts = np.unique(bkts_s, return_index=True)
    bounds = np.append(starts, len(bkts_s))
    result: Dict[int, np.ndarray] = {
        int(bk): np.sort(gids_s[bounds[i]:bounds[i + 1]]).astype(np.int64)
        for i, bk in enumerate(uniq)}
    routed = sum(len(v) for v in result.values())
    if routed != total:
        raise AssertionError(f"rescale routed {routed} of {total} rows")
    return result


def _validate_rescale(table, new_buckets: int):
    if not table.primary_keys or table.options.bucket < 1:
        raise ValueError("rescale targets fixed-bucket pk tables")
    if table.partition_keys:
        raise NotImplementedError("rescale of partitioned tables: loop "
                                  "partitions")
    if new_buckets < 1:
        raise ValueError("new_buckets must be >= 1")


def rescale_routing(table, values, new_buckets: int,
                    mesh=None) -> Dict[int, np.ndarray]:
    """{new_bucket: global row indices into `values`} through the mesh
    dispatch, checked bit for bit against the host bucket formula."""
    from paimon_tpu_torch.core.bucket import KeyHasher, _bucket_from_hash

    bucket_keys = table.schema.bucket_keys() or \
        table.schema.trimmed_primary_keys()
    rt = table.schema.logical_row_type()
    hasher = KeyHasher(bucket_keys,
                       [rt.get_field(k).type for k in bucket_keys])
    hashes = (hasher.hashes(values)
              & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    routing = rescale_dispatch_sharded(hashes, new_buckets, mesh)
    host_buckets = _bucket_from_hash(hashes, new_buckets)
    for b, gids in routing.items():
        if not (host_buckets[gids] == b).all():
            raise AssertionError("device routing diverged from the "
                                 "reference bucket formula")
    return routing


def rescale_write_messages(table, values, routing, new_buckets: int,
                           buckets: Optional[List[int]] = None):
    """Write the rescaled bucket files for `buckets` (default: every
    routed bucket) and return their CommitMessages."""
    import pyarrow as pa

    from paimon_tpu_torch.core.write import CommitMessage, build_kv_table
    from paimon_tpu_torch.ops.merge import sort_table
    from paimon_tpu_torch.parallel.mesh_engine import _EngineContext

    ctx = _EngineContext(table)
    wanted = None if buckets is None else {int(b) for b in buckets}
    messages: List[CommitMessage] = []
    for b, gids in sorted(routing.items()):
        if wanted is not None and int(b) not in wanted:
            continue
        rows = values.take(pa.array(gids))
        kv = build_kv_table(rows, table.schema,
                            np.arange(rows.num_rows, dtype=np.int64),
                            np.zeros(rows.num_rows, dtype=np.int8))
        order = sort_table(kv, ctx.key_cols, key_encoder=ctx.key_encoder,
                           device=table.device)
        kv = kv.take(pa.array(order))
        metas = ctx.writer.write((), int(b), kv, level=ctx.max_level)
        messages.append(CommitMessage((), int(b), new_buckets,
                                      new_files=metas))
    return messages


def rescale_commit(table, new_buckets: int, messages) -> Optional[int]:
    """Publish a rescale: set the bucket option first, then overwrite
    with the reorganised data (the reference procedure's order; writers
    pause for the whole rescale).  If the overwrite fails, the option is
    set back, so the old layout stays consistent with the schema."""
    from paimon_tpu_torch.core.commit import FileStoreCommit
    from paimon_tpu_torch.schema import SchemaChange, SchemaManager

    sm = SchemaManager(table.file_io, table.path, table.branch)
    sm.commit_changes(SchemaChange.set_option("bucket", str(new_buckets)))
    try:
        sid = FileStoreCommit(table.file_io, table.path, table.schema,
                              table.options, branch=table.branch) \
            .overwrite(messages)
    except BaseException:
        sm.commit_changes(SchemaChange.set_option(
            "bucket", str(table.options.bucket)))
        raise
    return sid


def rescale_table_buckets(table, new_buckets: int, mesh=None
                          ) -> Optional[int]:
    """Rewrite a fixed-bucket primary-key table to `new_buckets`: the
    mesh computes the routing (abs(hash % B) and the all_to_all), the
    host moves rows, writes the new bucket files and commits an
    overwrite, after recording the new bucket count in the schema."""
    from paimon_tpu_torch.parallel.mesh_engine import _single_process
    from paimon_tpu_torch.parallel.sharded_merge import bucket_mesh

    _validate_rescale(table, new_buckets)
    if mesh is None:
        mesh = bucket_mesh(device=table.device)
    _single_process(mesh)
    values = table.to_arrow()      # the merged current state
    if values.num_rows == 0:
        return None
    routing = rescale_routing(table, values, new_buckets, mesh)
    messages = rescale_write_messages(table, values, routing, new_buckets)
    return rescale_commit(table, new_buckets, messages)
