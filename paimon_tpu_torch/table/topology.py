"""Multi-writer streaming ingest topology.

reference: flink/sink/FlinkSink.java:75 — the sink is a topology of N
parallel WRITER operators fed by a bucket shuffle
(table/sink/ChannelComputer.java routes each row's (partition, bucket)
to `abs(hash % parallelism)`) and ONE committer operator
(flink/sink/CommitterOperator.java) that commits every checkpoint's
committables under a single commit identifier.

Python shape: writer WORKERS are threads, each owning the disjoint set
of buckets whose channel hashes to it (so per-bucket sequence numbers
never interleave); `write()` shuffles an Arrow batch to its owners with
one vectorized bucket assignment, `checkpoint(id)` barriers the
workers, gathers their commit messages and commits them exactly-once
under the identifier (replayed checkpoints are filtered like the
reference's committer state).

Counterpart of paimon_tpu/table/topology.py.  Each worker's flushes
merge on the table's device (the card's winner-select kernel on cuda).
What overlaps across workers: Arrow's parquet encode and decode, the
host sorts and takes around each merge, and the uploads release the
GIL; the workers' device work does not overlap, since every thread
launches onto the card's one default stream, where it runs in launch
order (each thread's copies back to the host wait for its own work
and whatever was queued before it).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from paimon_tpu_torch.utils.deadline import check_deadline

import numpy as np
import pyarrow as pa

__all__ = ["StreamIngestTopology"]

_STOP = object()


class _Worker:
    def __init__(self, write):
        self.write = write
        self.q: "queue.Queue" = queue.Queue()
        self.error: Optional[BaseException] = None
        from paimon_tpu_torch.parallel.executors import spawn_thread
        self.thread = spawn_thread(self._run, name="paimon-ingest-worker")

    def _run(self):
        while True:
            # lint-ok: deadline-wait the worker's idle inbox wait: a
            # daemon thread parked with no request waiting on it;
            # lifecycle (not a deadline) bounds it — stop() enqueues
            # _STOP and joins
            item = self.q.get()
            if item is _STOP:
                return
            kind = item[0]
            try:
                if kind == "write":
                    _, table, kinds, buckets = item
                    self.write.write_arrow(table, kinds,
                                           buckets=buckets)
                elif kind == "prepare":
                    _, out, done = item
                    if self.error is None:
                        # a failed worker never drains its staging:
                        # the topology is fail-stop (see checkpoint)
                        out.extend(self.write.prepare_commit())
                    done.set()
            except BaseException as e:     # noqa: BLE001
                self.error = e
                if kind == "prepare":
                    item[2].set()

    def submit_write(self, table: pa.Table, kinds: np.ndarray,
                     buckets=None):
        if self.error:
            raise RuntimeError("writer worker failed") from self.error
        self.q.put(("write", table, kinds, buckets))

    def prepare(self) -> List:
        out: List = []
        done = threading.Event()
        self.q.put(("prepare", out, done))
        # bounded wait: the worker sets `done` on success AND on
        # failure, but a request whose deadline is spent must not
        # wait out a wedged writer
        while not done.wait(0.2):
            check_deadline("stream ingest prepare")
        if self.error:
            raise RuntimeError("writer worker failed") from self.error
        return out

    def stop(self):
        self.q.put(_STOP)
        self.thread.join(timeout=30)


class StreamIngestTopology:
    """N bucket-sharded writer threads + one exactly-once committer."""

    def __init__(self, table, num_writers: int = 4,
                 commit_user: str = "stream-ingest"):
        from paimon_tpu_torch.core.bucket import FixedBucketAssigner
        from paimon_tpu_torch.core.write import ROW_KIND_COL  # noqa: F401

        self.table = table
        self.num_writers = max(1, num_writers)
        builder = table.new_stream_write_builder() \
            .with_commit_user(commit_user)
        self._builder = builder
        if table.options.bucket == -1 and table.primary_keys:
            raise ValueError(
                "dynamic-bucket tables need a single writer (the bucket "
                "assigner is stateful); use num_writers=1 via the plain "
                "stream write builder")
        if table.options.bucket == -2 and self.num_writers > 1:
            raise ValueError(
                "bucket-postpone tables stage rows unhashed in one "
                "virtual bucket; parallel writers would interleave "
                "sequence numbers per key — use num_writers=1")
        self._workers = [_Worker(builder.new_write())
                         for _ in range(self.num_writers)]
        if table.options.bucket >= 1 and table.primary_keys:
            bucket_keys = table.schema.bucket_keys()
            rt = table.schema.logical_row_type()
            self._assigner = FixedBucketAssigner(
                bucket_keys,
                [rt.get_field(k).type for k in bucket_keys],
                table.options.bucket)
        else:
            self._assigner = None
        self._rr = 0

    # -- the shuffle (reference ChannelComputer) -----------------------------

    def _channels(self, table: pa.Table):
        """-> (channel per row, bucket per row or None)."""
        if self._assigner is not None:
            buckets = self._assigner.assign(table)
            return (buckets % self.num_writers).astype(np.int32), buckets
        # bucket-unaware append: whole batches round-robin (the
        # reference's rebalance shuffle); rows need not split
        self._rr = (self._rr + 1) % self.num_writers
        return np.full(table.num_rows, self._rr, dtype=np.int32), None

    def write(self, table: pa.Table,
              row_kinds: Optional[np.ndarray] = None):
        from paimon_tpu_torch.core.write import extract_row_kinds

        table, row_kinds = extract_row_kinds(table, row_kinds)
        channels, buckets = self._channels(table)
        for ch in np.unique(channels):
            idx = np.flatnonzero(channels == ch)
            # the shuffle's bucket assignment rides along so workers
            # never re-hash the rows
            self._workers[int(ch)].submit_write(
                table.take(pa.array(idx)), row_kinds[idx],
                None if buckets is None else buckets[idx])

    def write_dicts(self, rows: Sequence[dict], row_kinds=None):
        cols: Dict[str, list] = {}
        schema = self.table.arrow_schema()
        for f in schema:
            cols[f.name] = [r.get(f.name) for r in rows]
        t = pa.table({k: pa.array(v, schema.field(k).type)
                      for k, v in cols.items()})
        kinds = None if row_kinds is None else np.asarray(row_kinds,
                                                         np.int8)
        self.write(t, kinds)

    # -- the committer (reference CommitterOperator) -------------------------

    def checkpoint(self, commit_identifier: int) -> Optional[int]:
        """Barrier all writers, gather their committables, commit them
        exactly once under `commit_identifier` (a replayed identifier
        is a no-op, like the reference's filter on recovery).

        FAIL-STOP like the reference job model: if any worker failed,
        checkpoint raises, NOTHING from this checkpoint commits, and
        recovery is a NEW topology replaying every batch since the last
        committed identifier — the exactly-once filter makes the replay
        safe and the abandoned staged files become orphans for
        remove_orphan_files."""
        msgs: List = []
        for w in self._workers:
            msgs.extend(w.prepare())
        commit = self._builder.new_commit()
        if not commit.filter_committed([commit_identifier]):
            # replayed checkpoint: its rewritten files are duplicates of
            # already-committed data — drop them (orphan clean reaps
            # the files), do NOT defer them to a later checkpoint
            return None
        return commit.commit(msgs, commit_identifier=commit_identifier)

    def close(self):
        for w in self._workers:
            w.stop()
