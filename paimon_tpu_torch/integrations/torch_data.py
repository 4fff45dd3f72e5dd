"""PyTorch integration: stream a paimon table as an IterableDataset.

Counterpart of paimon_tpu/integrations/torch_data.py.

The reference integrates with Python training stacks through Ray/Daft
readers (pypaimon/ray/ray_paimon.py, daft/daft_datasource.py) whose
unit of parallelism is the paimon split.  Same design here: the scan
plan's splits are the shard unit — split across DataLoader workers (and
optionally across distributed ranks), each worker merge-reads only its
own splits, so no two workers decode the same file.

Numeric columns become CPU torch tensors (the caller pins them or moves
them); strings/binaries/other types stay as Python lists per batch.
"""

from typing import Any, Dict, Iterator, List, Optional

import pyarrow as pa
import torch.utils.data as _tud


def _to_torch_batch(t: pa.Table) -> Dict[str, Any]:
    """Numeric and boolean columns as CPU tensors (booleans as uint8, an
    integer column with nulls as float64 with NaN, as Arrow's to_numpy
    gives them), every other column as a Python list.  A boolean column
    with nulls comes out as float64 with NaN too (paimon_tpu raises
    TypeError on its object array).  A tensor owns its memory: Arrow's
    read-only buffers are copied, never shared."""
    import numpy as np
    import torch

    out: Dict[str, Any] = {}
    for name in t.column_names:
        col = t.column(name)
        if pa.types.is_integer(col.type) or pa.types.is_floating(col.type) \
                or pa.types.is_boolean(col.type):
            if pa.types.is_boolean(col.type) and col.null_count:
                col = col.cast(pa.float64())
            np_col = col.to_numpy(zero_copy_only=False)
            if np_col.dtype == np.bool_:
                np_col = np_col.astype(np.uint8)
            elif not np_col.flags.writeable:
                np_col = np_col.copy()
            out[name] = torch.from_numpy(np_col)
        else:
            out[name] = col.to_pylist()
    return out


class PaimonIterableDataset(_tud.IterableDataset):
    """`torch.utils.data.IterableDataset` over a table scan.

    Splits are deterministically assigned round-robin to
    (rank, worker) pairs, so the union over all workers of all ranks is
    exactly one pass over the table.  A plain module-level subclass so
    instances pickle for spawn/forkserver DataLoader workers: the table
    pickles as its path, options, branch and device, and a worker
    loads it again from its path (a path whose FileIO the worker's
    process can resolve), so a worker's reads merge on the table's
    device, each worker in a CUDA context of its own on cuda.
    """

    def __init__(self, table, projection: Optional[List[str]] = None,
                 predicate=None, batch_size: int = 8192,
                 rank: int = 0, world_size: int = 1):
        self.table = table
        self.projection = projection
        self.predicate = predicate
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size

    def __getstate__(self):
        state = dict(self.__dict__)
        t = state.pop("table")
        state["_table_ref"] = (t.path, dict(t.schema.options), t.branch,
                               str(t.device))
        return state

    def __setstate__(self, state):
        from paimon_tpu_torch.table import FileStoreTable
        path, options, branch, device = state.pop("_table_ref")
        self.__dict__.update(state)
        self.table = FileStoreTable.load(
            path, dynamic_options={**options, "branch": branch},
            device=device)

    def _read_builder(self):
        rb = self.table.new_read_builder()
        if self.projection:
            rb = rb.with_projection(self.projection)
        if self.predicate is not None:
            rb = rb.with_filter(self.predicate)
        return rb

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        import torch.utils.data as tud

        info = tud.get_worker_info()
        wid = info.id if info is not None else 0
        nworkers = info.num_workers if info is not None else 1
        shard = self.rank * nworkers + wid
        nshards = self.world_size * nworkers

        rb = self._read_builder()
        splits = rb.new_scan().plan().splits
        read = rb.new_read()
        mine = [s for i, s in enumerate(splits) if i % nshards == shard]
        # pipelined reader (parallel/scan_pipeline.py): the next split
        # downloads/decodes while this worker converts batches
        for _, _, t in read.iter_splits(mine):
            for start in range(0, t.num_rows, self.batch_size):
                yield _to_torch_batch(t.slice(start, self.batch_size))


def to_torch_dataloader(table, projection: Optional[List[str]] = None,
                        predicate=None, batch_size: int = 8192,
                        num_workers: int = 0, **loader_kwargs):
    """A DataLoader of column-dict batches.  Batching happens at the
    Arrow layer (batch_size rows per yielded dict), so the loader runs
    with batch_size=None (no re-collation).

    Workers of a table on cuda start under the "spawn" context unless
    `multiprocessing_context` is given: a process that has opened a CUDA
    context cannot fork workers that use the card.  Each worker loads
    the table again on its device and merges its splits there."""
    import torch.utils.data as tud

    if num_workers > 0 and table.device.type == "cuda":
        loader_kwargs.setdefault("multiprocessing_context", "spawn")
    ds = PaimonIterableDataset(table, projection, predicate, batch_size)
    return tud.DataLoader(ds, batch_size=None, num_workers=num_workers,
                          **loader_kwargs)
