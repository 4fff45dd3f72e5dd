"""ConsumerManager: per-consumer-id streaming progress (``consumer/``).

A copy of paimon_tpu/snapshot/consumer_manager.py (no JAX in it); the
files it writes are the reference's, so either package resumes the
other's consumers.

reference: paimon-core/.../consumer/ConsumerManager.java -- a consumer file
records next-snapshot for a streaming reader; protects snapshots from
expiry and lets readers resume.
"""

from __future__ import annotations

import json
import time as _time
from typing import Dict, Optional

from paimon_tpu_torch.fs import FileIO

__all__ = ["ConsumerManager"]

CONSUMER_PREFIX = "consumer-"


class ConsumerManager:
    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")

    @property
    def consumer_dir(self) -> str:
        return f"{self.table_path}/consumer"

    def consumer_path(self, consumer_id: str) -> str:
        return f"{self.consumer_dir}/{CONSUMER_PREFIX}{consumer_id}"

    def consumer(self, consumer_id: str) -> Optional[int]:
        path = self.consumer_path(consumer_id)
        if not self.file_io.exists(path):
            return None
        return json.loads(self.file_io.read_utf8(path))["nextSnapshot"]

    def record_consumer(self, consumer_id: str, next_snapshot: int):
        self.file_io.write_utf8(
            self.consumer_path(consumer_id),
            json.dumps({"nextSnapshot": next_snapshot,
                        "lastModified": int(_time.time() * 1000)}))

    def delete_consumer(self, consumer_id: str):
        self.file_io.delete_quietly(self.consumer_path(consumer_id))

    def consumers(self) -> Dict[str, int]:
        out = {}
        for st in self.file_io.list_status(self.consumer_dir):
            fname = st.path.rstrip("/").split("/")[-1]
            if fname.startswith(CONSUMER_PREFIX):
                cid = fname[len(CONSUMER_PREFIX):]
                v = self.consumer(cid)
                if v is not None:
                    out[cid] = v
        return out

    def min_next_snapshot(self) -> Optional[int]:
        """Smallest consumer progress -- lower bound protected from expiry."""
        vals = self.consumers().values()
        return min(vals) if vals else None

    def expire_stale(self, expire_ms: int):
        now = int(_time.time() * 1000)
        for st in self.file_io.list_status(self.consumer_dir):
            fname = st.path.rstrip("/").split("/")[-1]
            if not fname.startswith(CONSUMER_PREFIX):
                continue
            try:
                d = json.loads(self.file_io.read_utf8(st.path))
                if now - d.get("lastModified", now) > expire_ms:
                    self.file_io.delete_quietly(st.path)
            except (OSError, ValueError):
                pass
