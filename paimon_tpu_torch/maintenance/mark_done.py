"""Partition mark-done: notify downstream that a partition finished
writing.

reference: partition/actions/PartitionMarkDoneAction.java (SPI),
SuccessFileMarkDoneAction.java (writes `_SUCCESS` JSON into the
partition dir, key-compatible `partition/file/SuccessFile.java`),
AddDonePartitionAction.java / MarkPartitionDoneEventAction.java
(metastore registrations — here a file-backed metastore analog under
`<table>/partition-mark-done/`), HttpReportMarkDoneAction.java, and the
streaming trigger flink/sink/listener/PartitionMarkDoneTrigger.java
(idle-time + partition-time-interval semantics, checkpointable pending
state).

Config (CoreOptions + connector options, same keys):
  partition.mark-done-action        csv of success-file | done-partition
                                    | mark-event | http-report | custom
  partition.mark-done-action.custom.class   "module:Class" here
  partition.mark-done-action.http.url/.params
  partition.mark-done-when-end-input
  partition.idle-time-to-done / partition.time-interval

A copy of paimon_tpu/maintenance/mark_done.py (no JAX in it): the
markers and done-partition files are the reference's.
"""

from __future__ import annotations

import json
import time as _time
from typing import Dict, List, Optional, Sequence

from paimon_tpu_torch.fs import FileIO, safe_join
from paimon_tpu_torch.options import CoreOptions

__all__ = [
    "SuccessFile", "PartitionMarkDoneAction", "SuccessFileMarkDoneAction",
    "AddDonePartitionAction", "MarkPartitionDoneEventAction",
    "HttpReportMarkDoneAction", "create_mark_done_actions",
    "mark_partitions_done", "PartitionMarkDoneTrigger",
]

SUCCESS_FILE_NAME = "_SUCCESS"


class SuccessFile:
    """`_SUCCESS` marker content (partition/file/SuccessFile.java —
    same JSON keys)."""

    def __init__(self, creation_time: int, modification_time: int):
        self.creation_time = creation_time
        self.modification_time = modification_time

    def to_json(self) -> str:
        return json.dumps({"creationTime": self.creation_time,
                           "modificationTime": self.modification_time})

    @staticmethod
    def from_json(text: str) -> "SuccessFile":
        d = json.loads(text)
        return SuccessFile(d["creationTime"], d["modificationTime"])


class PartitionMarkDoneAction:
    def mark_done(self, partition: str) -> None:
        """`partition` is the relative partition path, e.g.
        'dt=2026-07-29' or 'dt=2026-07-29/hr=12'."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SuccessFileMarkDoneAction(PartitionMarkDoneAction):
    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")

    def mark_done(self, partition: str) -> None:
        path = safe_join(self.table_path,
                         f"{partition}/{SUCCESS_FILE_NAME}")
        now = int(_time.time() * 1000)
        sf = SuccessFile(now, now)
        if self.file_io.exists(path):
            try:
                prev = SuccessFile.from_json(
                    self.file_io.read_bytes(path).decode("utf-8"))
                sf = SuccessFile(prev.creation_time, now)
            except (ValueError, KeyError):
                pass                 # unreadable marker: rewrite fresh
        self.file_io.write_bytes(path, sf.to_json().encode("utf-8"),
                                 overwrite=True)


class _FileMetastoreMarkDone(PartitionMarkDoneAction):
    """File-backed analog of the reference's metastore registrations:
    the catalog has no Hive metastore here, so done-partitions and
    mark-events persist under `<table>/partition-mark-done/`."""

    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.dir = f"{table_path.rstrip('/')}/partition-mark-done"


class AddDonePartitionAction(_FileMetastoreMarkDone):
    """reference AddDonePartitionAction: registers a '<partition>.done'
    partition in the metastore.  One marker file per partition — a
    single rewritten JSON list would lose registrations under
    concurrent markers (read-modify-write race)."""

    def mark_done(self, partition: str) -> None:
        rel = partition.rstrip("/")
        path = safe_join(f"{self.dir}/done-partitions", rel + ".done")
        self.file_io.write_bytes(path, b"", overwrite=True)

    def done_partitions(self) -> List[str]:
        d = f"{self.dir}/done-partitions"
        if not self.file_io.exists(d):
            return []
        prefix = d.rstrip("/") + "/"
        return sorted(
            st.path[len(prefix):]
            for st in self.file_io.list_status_recursive(d)
            if st.path.endswith(".done"))


class MarkPartitionDoneEventAction(_FileMetastoreMarkDone):
    """reference MarkPartitionDoneEventAction: a 'partition done' event
    per mark.  One sortable-named file per event (O(1) per mark and
    atomic — a rewritten single log would be O(n^2) and truncatable)."""

    def mark_done(self, partition: str) -> None:
        import uuid
        now = int(_time.time() * 1000)
        event = json.dumps({"partition": partition,
                            "event": "partition.done",
                            "timeMillis": now})
        path = f"{self.dir}/events/{now:020d}-{uuid.uuid4().hex[:8]}.json"
        self.file_io.write_bytes(path, event.encode("utf-8"),
                                 overwrite=False)

    def events(self) -> List[dict]:
        """All recorded events, oldest first."""
        d = f"{self.dir}/events"
        if not self.file_io.exists(d):
            return []
        return [json.loads(self.file_io.read_bytes(p))
                for p in sorted(self.file_io.list_files(d))]


class HttpReportMarkDoneAction(PartitionMarkDoneAction):
    """reference HttpReportMarkDoneAction: POSTs {table, partition,
    params} JSON to the configured endpoint."""

    def __init__(self, url: str, table_id: str,
                 params: Optional[str] = None, timeout: float = 10.0):
        if not url:
            raise ValueError(
                "partition.mark-done-action.http.url is required for the "
                "http-report mark-done action")
        self.url = url
        self.table_id = table_id
        self.params = params
        self.timeout = timeout

    def mark_done(self, partition: str) -> None:
        import urllib.error
        import urllib.request
        body = json.dumps({"table": self.table_id, "partition": partition,
                           "params": self.params}).encode("utf-8")
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass                 # urlopen raises on non-2xx
        except urllib.error.HTTPError as e:
            raise IOError(
                f"mark-done http-report to {self.url} failed: "
                f"{e.code} {e.reason}") from e


def create_mark_done_actions(table) -> List[PartitionMarkDoneAction]:
    """Parse `partition.mark-done-action` (csv) into action instances."""
    options = table.options
    spec = options.get(CoreOptions.PARTITION_MARK_DONE_ACTION)
    actions: List[PartitionMarkDoneAction] = []
    for name in [s.strip() for s in spec.split(",") if s.strip()]:
        if name == "success-file":
            actions.append(SuccessFileMarkDoneAction(table.file_io,
                                                     table.path))
        elif name == "done-partition":
            actions.append(AddDonePartitionAction(table.file_io,
                                                  table.path))
        elif name == "mark-event":
            actions.append(MarkPartitionDoneEventAction(table.file_io,
                                                        table.path))
        elif name == "http-report":
            actions.append(HttpReportMarkDoneAction(
                options.get(CoreOptions.PARTITION_MARK_DONE_HTTP_URL),
                table.name,
                options.get(CoreOptions.PARTITION_MARK_DONE_HTTP_PARAMS)))
        elif name == "custom":
            cls_spec = options.get(
                CoreOptions.PARTITION_MARK_DONE_CUSTOM_CLASS)
            if not cls_spec:
                raise ValueError(
                    "partition.mark-done-action.custom.class is required "
                    "for the custom mark-done action")
            import importlib
            mod, _, cls = cls_spec.partition(":")
            actions.append(getattr(importlib.import_module(mod), cls)(table))
        else:
            raise ValueError(f"Unknown partition.mark-done-action '{name}'")
    return actions


def _partition_rel_path(table, partition) -> str:
    """partition tuple/dict/str -> relative 'k=v/k=v' path.  Rejects
    traversal — these strings reach the filesystem from SQL
    (CALL sys.mark_partition_done)."""
    if isinstance(partition, str):
        rel = partition.strip("/")
    else:
        keys = table.partition_keys
        if isinstance(partition, dict):
            missing = [k for k in keys if k not in partition]
            if missing:
                raise ValueError(f"partition value missing keys {missing}")
            values = [partition[k] for k in keys]
        else:
            values = list(partition)
            if len(values) != len(keys):
                raise ValueError(
                    f"partition {values!r} does not match partition keys "
                    f"{keys} (got {len(values)} values, need {len(keys)})")
        rel = "/".join(f"{k}={v}" for k, v in zip(keys, values))
    safe_join(table.path, rel)       # raises on '..' / absolute / empty
    return rel


def mark_partitions_done(table, partitions: Sequence) -> List[str]:
    """Apply every configured mark-done action to `partitions` (tuples,
    dicts or 'k=v' path strings). Returns the marked relative paths.
    reference: flink/procedure/MarkPartitionDoneProcedure.java."""
    if not table.partition_keys:
        raise ValueError("table is not partitioned")
    actions = create_mark_done_actions(table)
    rels = [_partition_rel_path(table, p) for p in partitions]
    try:
        for rel in rels:
            for a in actions:
                a.mark_done(rel)
    finally:
        for a in actions:
            a.close()
    return rels


class PartitionMarkDoneTrigger:
    """Decides WHEN a partition is done, mirroring the reference's
    streaming trigger (flink/sink/listener/PartitionMarkDoneTrigger.java):

    - every write to a partition calls notify(partition)
    - a partition is done when now - max(last_update, partition_start +
      time_interval) > idle_time
    - end_input marks everything pending (partition.mark-done-when-end-input)

    Pending state round-trips through snapshot()/restore() so a stream
    writer can checkpoint it."""

    def __init__(self, table, time_interval_ms: Optional[int] = None,
                 idle_time_ms: Optional[int] = None,
                 mark_done_when_end_input: Optional[bool] = None):
        options = table.options
        self.table = table
        self.time_interval = (time_interval_ms if time_interval_ms
                              is not None else options.get(
                                  CoreOptions.PARTITION_TIME_INTERVAL))
        self.idle_time = (idle_time_ms if idle_time_ms is not None
                          else options.get(
                              CoreOptions.PARTITION_IDLE_TIME_TO_DONE))
        self.end_input_marks = (
            mark_done_when_end_input if mark_done_when_end_input is not None
            else options.get(CoreOptions.PARTITION_MARK_DONE_WHEN_END_INPUT)
            # partition.end-input-to-done is the reference's name for
            # the same end-of-input semantics: either knob enables it
            or options.get(CoreOptions.PARTITION_END_INPUT_TO_DONE))
        if (self.idle_time is None) != (self.time_interval is None):
            # silently never marking anything would be indistinguishable
            # from "nothing is idle yet"
            raise ValueError(
                "partition.idle-time-to-done and partition.time-interval "
                "must be set together (or neither, with "
                "partition.mark-done-when-end-input)")
        self._pending: Dict[str, int] = {}

    def notify(self, partition, now_ms: Optional[int] = None) -> None:
        rel = _partition_rel_path(self.table, partition)
        self._pending[rel] = (now_ms if now_ms is not None
                              else int(_time.time() * 1000))

    def done_partitions(self, end_input: bool = False,
                        now_ms: Optional[int] = None,
                        remove: bool = True) -> List[str]:
        due = self._due(end_input, now_ms)
        if remove:
            for rel in due:
                self._pending.pop(rel, None)
        return due

    def _due(self, end_input: bool, now_ms: Optional[int]) -> List[str]:
        if end_input and self.end_input_marks:
            return list(self._pending)
        if self.time_interval is None or self.idle_time is None:
            return []
        now = now_ms if now_ms is not None else int(_time.time() * 1000)
        due = []
        for rel, last_update in list(self._pending.items()):
            start = self._partition_start_ms(rel)
            if start is None:               # unparseable: drop (reference
                del self._pending[rel]      # skips illegal partitions)
                continue
            effective = max(last_update, start + self.time_interval)
            if now - effective > self.idle_time:
                due.append(rel)
        return due

    def mark(self, end_input: bool = False,
             now_ms: Optional[int] = None) -> List[str]:
        """Run the actions for every due partition; a partition leaves
        the pending set only AFTER its actions succeeded, so a failing
        action (e.g. http endpoint down) retries on the next mark()."""
        due = self.done_partitions(end_input, now_ms, remove=False)
        done = []
        try:
            for rel in due:
                mark_partitions_done(self.table, [rel])
                done.append(rel)
        finally:
            for rel in done:
                self._pending.pop(rel, None)
        return done

    # -- checkpoint state ---------------------------------------------------

    def snapshot(self) -> List[str]:
        return list(self._pending)

    def restore(self, partitions: Sequence[str],
                now_ms: Optional[int] = None) -> None:
        now = now_ms if now_ms is not None else int(_time.time() * 1000)
        for p in partitions:
            self._pending.setdefault(p, now)

    # -- helpers ------------------------------------------------------------

    def _partition_start_ms(self, rel: str) -> Optional[int]:
        """Partition time via the SAME extractor partition expiry uses
        (partition_expire.partition_time_ms); None (-> dropped) for
        anything unparseable, including non-'k=v' strings a restore()
        may have injected."""
        from paimon_tpu_torch.maintenance.partition_expire import (
            partition_time_ms,
        )
        try:
            values = dict(part.split("=", 1) for part in rel.split("/"))
        except ValueError:
            return None
        return partition_time_ms(self.table.options, values)
