"""Multi-host bootstrap, topology helpers and agreement primitives over
torch.distributed.

Counterpart of paimon_tpu/parallel/multihost.py.  The reference brings
up jax's distributed runtime, so that the devices of every host form
one global mesh.  Here every host (process) joins one gloo process
group (`torch.distributed.init_process_group(backend="gloo",
init_method="tcp://<coordinator>", world_size, rank)`) and drives its
own card.  Gloo, not NCCL: NCCL refuses two ranks on one card, and the
planes' collectives carry host bytes (commit messages, Arrow IPC rows,
one snapshot id), which gloo moves without staging.

- `initialize(...)`: the process group, with the reference's environment
  fallbacks (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID).
- `global_mesh(...)`: a parallel.BucketMesh over every process, one lane
  a process on its own device.
- `process_local_batch(...)`: each process's host columns as one column
  sharded along the processes (`ShardedColumn`, the port's form of a
  DTensor with Shard(0)), this process's shard on its own device.
- `assign_splits(...)`: deterministic byte-size-aware split ownership
  (the same LPT as parallel/packing.py).
- `barrier(...)` / `broadcast_value(...)` / `allgather_bytes(...)`: the
  agreement primitives parallel/distributed.py builds commit
  arbitration, pinned-snapshot scans and rescale handoffs on, each over
  host tensors.

Everything degrades to one process: `initialize` does nothing when
num_processes == 1, the mesh is one lane, split assignment returns
everything and the agreement primitives return their inputs without a
collective.  A collective with a dead member fails once the group's
timeout runs out; the planes run none after a host dies (leases decide
death from the store, parallel/maintenance_plane.py).
"""

from __future__ import annotations

import datetime
import os
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["initialize", "peer_death_tolerance", "process_index",
           "process_count", "global_mesh", "process_local_batch",
           "ShardedColumn", "split_weight", "assign_splits",
           "distributed_write_commit_user", "barrier", "broadcast_value",
           "allgather_bytes"]

# how long a collective (and the group's bring-up) waits for its peers
DEFAULT_TIMEOUT_S = 300.0


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The default group's size (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


# for functions whose parameters take the names above
_rank, _world = process_index, process_count


def peer_death_tolerance(max_missing_heartbeats: Optional[int] = None
                         ) -> dict:
    """The reference's heartbeat-tolerance kwargs, from the explicit
    argument or the `PAIMON_MULTIHOST_PEER_MISSED_HEARTBEATS` env var;
    empty when neither is set.

    In torch.distributed they map to nothing.  jax's coordination
    service declares a peer that misses its heartbeats crashed and
    tears down every other task, which this tolerance widens; gloo has
    no such service.  A survivor of a dead peer is not aborted: a
    collective it enters with the dead peer fails after the group's
    timeout, and the planes enter none after a death (a survivor's
    leases govern the takeover).  `initialize` parses the value the
    reference's way and passes it nowhere."""
    if max_missing_heartbeats is None:
        env = os.environ.get("PAIMON_MULTIHOST_PEER_MISSED_HEARTBEATS")
        if env:
            max_missing_heartbeats = int(env)
    if max_missing_heartbeats is None:
        return {}
    return {"service_max_missing_heartbeats": max_missing_heartbeats,
            "client_max_missing_heartbeats": max_missing_heartbeats}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               max_missing_heartbeats: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Join the multi-host gloo group.  Arguments default from the
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID environment
    variables; one process does nothing.  `coordinator_address` is
    host:port (process 0 serves the rendezvous store there) or a full
    init method URL (tcp://, file://).  Returns (process_index,
    process_count)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or \
        os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    peer_death_tolerance(max_missing_heartbeats)
    if num_processes > 1 and not _initialized():
        if not coordinator_address:
            raise ValueError("a multi-process group needs a coordinator "
                             "address (COORDINATOR_ADDRESS)")
        if not dist.is_gloo_available():
            # not silent: the group's first collective fails later with
            # a far less telling error
            import warnings

            from paimon_tpu_torch.metrics import (
                MULTIHOST_CONFIG_WARNINGS, global_registry,
            )
            warnings.warn(
                "multihost.initialize: this torch build has no Gloo "
                "backend for cross-process collectives; the group's "
                "bring-up or its first collective will fail",
                RuntimeWarning, stacklevel=2)
            global_registry().multihost_metrics().counter(
                MULTIHOST_CONFIG_WARNINGS).inc()
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(
            backend="gloo", init_method=init, world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    return process_index(), process_count()


def global_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, device=None):
    """A parallel.BucketMesh over every process, one lane a process on
    `device` (None: cuda).  A multi-axis shape must multiply out to the
    process count; its axes flatten into the mesh's one lane axis."""
    from paimon_tpu_torch.parallel.sharded_merge import bucket_mesh

    count = process_count()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape is required for a multi-axis mesh")
        shape = (count,)
    if int(np.prod(shape)) != count:
        raise ValueError(f"mesh shape {tuple(shape)} != device count "
                         f"{count}")
    return bucket_mesh(count, device)


class ShardedColumn:
    """One column of rows concatenated along the processes, each process
    holding its own rows (the port's form of a DTensor placed Shard(0)):
    `local` on this process's device, `offset` its first global row,
    `shape` the global shape.  No process gathers the whole column."""

    def __init__(self, local: torch.Tensor, offset: int, global_rows: int,
                 group=None):
        self.local = local
        self.offset = offset
        self.global_rows = global_rows
        self.group = group

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.global_rows,) + tuple(self.local.shape[1:])

    def sum(self) -> torch.Tensor:
        """The global sum on this process's device: the local shard
        reduced on its device, then the partial sums all-reduced over
        the group.  The 0-d partial goes through host memory by hand
        (`.cpu()`, the all_reduce, back to the device): the planes'
        group is gloo's, whose work on CUDA tensors this does not rely
        on."""
        partial = self.local.sum()
        if self.group is None:
            return partial
        import torch.distributed as dist
        host = partial.cpu()
        dist.all_reduce(host, group=self.group)
        return host.to(self.local.device)


def process_local_batch(mesh, name_to_array: Dict[str, np.ndarray],
                        axis: str = "data") -> Dict[str, ShardedColumn]:
    """Each process's host-local numpy columns as ONE column per name,
    sharded along the processes in rank order: the shard is uploaded to
    this process's device (the mesh's), and only the row counts cross
    the group (parallel source readers each feeding their own
    worker)."""
    group = mesh.group if mesh.world > 1 else None
    out = {}
    for name, arr in name_to_array.items():
        arr = np.ascontiguousarray(arr)
        local = torch.from_numpy(arr).to(mesh.device)
        counts = [len(arr)]
        if group is not None:
            counts = [int(np.frombuffer(b, dtype=np.int64)[0]) for b in
                      allgather_bytes(np.int64(len(arr)).tobytes())]
        rank = mesh.rank
        out[name] = ShardedColumn(local, int(sum(counts[:rank])),
                                  int(sum(counts)), group)
    return out


def split_weight(split) -> int:
    """A split's assignment weight: on-disk bytes from manifest stats
    (DataFileMeta.file_size sums, known before any file IO, the same
    source as parallel/packing.bucket_row_counts).  Objects without
    data_files weigh 1, so plain sequences still round-robin."""
    files = getattr(split, "data_files", None)
    if not files:
        return 1
    return max(1, sum(int(f.file_size) for f in files))


def assign_splits(splits: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List:
    """Deterministic byte-size-aware split ownership: splits pack onto
    processes with the greedy LPT of parallel/packing.py keyed on
    manifest byte sizes.  Every process computes the SAME plan (the sort
    and its tie-breaks are total orders over (size, index)) and reads
    only its own share; no coordinator or shuffle is needed."""
    if process_index is None:
        process_index = _rank()
    if process_count is None:
        process_count = _world()
    if process_count <= 1:
        return list(splits)
    weights = [split_weight(s) for s in splits]
    order = sorted(range(len(splits)), key=lambda i: (-weights[i], i))
    loads = [0] * process_count
    mine: List[int] = []
    for i in order:
        target = min(range(process_count), key=lambda p: (loads[p], p))
        loads[target] += weights[i]
        if target == process_index:
            mine.append(i)
    # plan order within the owned share
    return [splits[i] for i in sorted(mine)]


def distributed_write_commit_user(base: str = "writer") -> str:
    """Per-process commit user of a multi-host writer: the snapshot CAS
    serializes the processes' independent commits."""
    return f"{base}-p{process_index()}"


# -- agreement primitives (parallel/distributed.py builds on these) ----------

def barrier(name: str = "barrier") -> float:
    """Block until every process reaches this point; returns the wait in
    milliseconds (also recorded in the multihost group's barrier_wait_ms
    histogram).  One process: 0 ms.  A request whose deadline is spent
    (utils/deadline.py) raises before it enters the collective."""
    if process_count() == 1:
        return 0.0
    import torch.distributed as dist

    from paimon_tpu_torch.metrics import (
        MULTIHOST_BARRIER_WAIT_MS, global_registry,
    )
    from paimon_tpu_torch.utils.deadline import check_deadline
    check_deadline(f"multihost barrier {name!r}")
    t0 = _time.perf_counter()
    dist.barrier()
    waited = (_time.perf_counter() - t0) * 1000
    global_registry().multihost_metrics().histogram(
        MULTIHOST_BARRIER_WAIT_MS).update(waited)
    return waited


def broadcast_value(value: int, root: int = 0) -> int:
    """Agree on one int64 across all processes: `root`'s value wins (the
    small broadcast that pins one snapshot id for a snapshot-consistent
    cross-host scan).  One process: the value."""
    if process_count() == 1:
        return int(value)
    import torch.distributed as dist

    from paimon_tpu_torch.utils.deadline import check_deadline
    check_deadline("multihost broadcast")
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(t, src=root)
    return int(t[0])


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Every process contributes one payload and receives ALL of them,
    indexed by process id.  Two phases, the int64 lengths and then a
    padded uint8 all_gather, so payloads of any sizes (empty too) come
    back exact.  The wire of coordinator arbitration and of 'exchange'
    routing.  One process: [payload]."""
    count = process_count()
    if count == 1:
        return [bytes(payload)]
    import torch.distributed as dist

    from paimon_tpu_torch.utils.deadline import check_deadline
    check_deadline("multihost allgather")
    data = np.frombuffer(bytes(payload), dtype=np.uint8)
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(count)]
    dist.all_gather(lengths, torch.tensor([len(data)], dtype=torch.int64))
    sizes = [int(t[0]) for t in lengths]
    max_len = max(1, max(sizes))
    padded = torch.zeros(max_len, dtype=torch.uint8)
    padded[:len(data)] = torch.from_numpy(data.copy())
    parts = [torch.empty(max_len, dtype=torch.uint8) for _ in range(count)]
    dist.all_gather(parts, padded)
    return [parts[p][:sizes[p]].numpy().tobytes() for p in range(count)]
