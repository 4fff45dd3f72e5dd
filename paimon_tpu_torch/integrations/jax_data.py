"""Device data loading: stream a table as fixed-shape batches of tensors
on the table's device.

Counterpart of paimon_tpu/integrations/jax_data.py, whose `jax_batches`
puts each batch on the accelerator with `jax.device_put`.  The name is
kept, so code written against the reference's loader runs unchanged;
here the batches are torch tensors: fixed-shape batches (a training
step's shapes never change), numeric columns only, on the table's
device, optionally split over a sequence of devices so each gets its
slice without a host-side gather.

Split reads route through the pipelined scan executor
(parallel/scan_pipeline.py): worker threads download/decode/merge the
next splits while the training loop consumes the current batch.  On a
CUDA device each column is staged in a pinned host buffer and copied
with `non_blocking=True` on a side stream, batch N+1's copy issued
before batch N is handed out; the consumer's stream waits on the copy's
event, and `record_stream` keeps the device tensor alive for it.  The
pinned buffers are reused two batches later, after their copy's event
has completed, so a batch already handed out is never overwritten.
"""

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa

_STAGES = 2          # pinned buffer sets: the batch in flight and the next


def _numeric_columns(schema: pa.Schema,
                     projection: Optional[List[str]]) -> List[str]:
    names = projection or schema.names
    out = []
    for n in names:
        t = schema.field(n).type
        if pa.types.is_integer(t) or pa.types.is_floating(t) or \
                pa.types.is_boolean(t):
            out.append(n)
    return out


class _Uploader:
    """Host batches to `device` (one device of the sharding): through
    pinned staging buffers and a side stream on cuda, by a copy on the
    CPU."""

    def __init__(self, device):
        import torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._pinned: List[Dict[str, Any]] = [{} for _ in
                                                  range(_STAGES)]
            self._done: List[Optional[Any]] = [None] * _STAGES
            self._turn = 0

    def put(self, arrs: Dict[str, np.ndarray]):
        """-> (tensors on the device, the copy's event or None)."""
        import torch
        if not self.cuda:
            return {k: torch.from_numpy(np.array(v)) for k, v in
                    arrs.items()}, None
        slot = self._turn % _STAGES
        self._turn += 1
        if self._done[slot] is not None:
            # the copy out of this slot's buffers must end before they
            # are written again
            self._done[slot].synchronize()
        pinned = self._pinned[slot]
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in arrs.items():
                buf = pinned.get(k)
                if buf is None or buf.numel() != v.size or \
                        buf.dtype != _torch_dtype(v.dtype):
                    buf = torch.empty(v.size, dtype=_torch_dtype(v.dtype),
                                      pin_memory=True)
                    pinned[k] = buf
                buf.numpy()[...] = v
                out[k] = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._done[slot] = done
        return out, done

    def hand_out(self, batch: Dict[str, Any], done) -> Dict[str, Any]:
        """`batch` ready for the consumer's current stream."""
        import torch
        if done is None:
            return batch
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in batch.values():
            t.record_stream(consumer)
        return batch


def _torch_dtype(dtype: np.dtype):
    import torch
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def jax_batches(table, batch_size: int,
                projection: Optional[List[str]] = None,
                predicate=None,
                drop_remainder: bool = True,
                sharding: Optional[Sequence[Any]] = None,
                ordered: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield dicts of tensors of EXACTLY batch_size rows on the table's
    device (fixed shapes; a short tail is dropped unless
    drop_remainder=False, where it is zero-padded and yielded with a
    `_mask` bool tensor).

    Non-numeric columns are skipped — a training loop consumes numbers;
    use torch_data / to_arrow for heterogeneous reads.  ValueError when
    no column is numeric.

    sharding: an optional sequence of devices, the counterpart of a
    `NamedSharding(mesh, P("data"))` over a 1-D mesh: each device gets
    its contiguous, equal share of a batch's rows, and each column of a
    yielded batch is the list of those shards in device order.
    ValueError where batch_size does not divide by their number.

    ordered=False lets splits arrive in completion order (faster under
    skew); set it only when batch composition across epochs need not be
    deterministic.
    """
    rb = table.new_read_builder()
    if projection:
        rb = rb.with_projection(projection)
    if predicate is not None:
        rb = rb.with_filter(predicate)
    plan = rb.new_scan().plan()
    read = rb.new_read()
    cols = _numeric_columns(table.arrow_schema(), projection)
    if not cols:
        raise ValueError("no numeric columns to batch; pass a "
                         "projection of numeric fields")
    devices = [table.device] if sharding is None else list(sharding)
    if not devices or batch_size % len(devices):
        raise ValueError(f"a batch of {batch_size} rows does not divide "
                         f"over {len(devices)} devices")
    share = batch_size // len(devices)
    uploaders = [_Uploader(d) for d in devices]

    def host_batches() -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-size numpy batches off the pipelined split reader."""
        pending: List[pa.Table] = []
        buffered = 0
        for _, _, t in read.iter_splits(plan.splits, ordered=ordered):
            t = t.select(cols)
            pending.append(t)
            buffered += t.num_rows
            while buffered >= batch_size:
                merged = pa.concat_tables(pending,
                                          promote_options="none")
                head = merged.slice(0, batch_size)
                rest = merged.slice(batch_size)
                pending = [rest] if rest.num_rows else []
                buffered = rest.num_rows
                yield {c: head.column(c).to_numpy(zero_copy_only=False)
                       for c in cols}
        if buffered and not drop_remainder:
            merged = pa.concat_tables(pending, promote_options="none")
            arrs = {}
            mask = np.zeros(batch_size, dtype=bool)
            mask[:merged.num_rows] = True
            for c in cols:
                v = merged.column(c).to_numpy(zero_copy_only=False)
                padded = np.zeros(batch_size, dtype=v.dtype)
                padded[: len(v)] = v
                arrs[c] = padded
            arrs["_mask"] = mask
            yield arrs

    def put(arrs: Dict[str, np.ndarray]):
        if sharding is None:
            return [uploaders[0].put(arrs)]
        return [u.put({k: v[i * share:(i + 1) * share]
                       for k, v in arrs.items()})
                for i, u in enumerate(uploaders)]

    def hand_out(staged) -> Dict[str, Any]:
        shards = [u.hand_out(b, done)
                  for u, (b, done) in zip(uploaders, staged)]
        if sharding is None:
            return shards[0]
        return {k: [s[k] for s in shards] for k in shards[0]}

    # double buffer: batch N+1's copy is issued before batch N is
    # yielded, so the copy overlaps the consumer's step on batch N
    staged = None
    for arrs in host_batches():
        batch = put(arrs)
        if staged is not None:
            yield hand_out(staged)
        staged = batch
    if staged is not None:
        yield hand_out(staged)
