"""TagManager: named immutable refs to snapshots (``tag/tag-<name>``).

reference: paimon-core/.../utils/TagManager.java; a tag file stores the
snapshot JSON it pins, protecting its files from expiry.

A copy of paimon_tpu/snapshot/tag_manager.py (no JAX in it); the
tag files are the reference's, so either package reads the other's tags.
"""

from __future__ import annotations

from typing import Dict, List

from paimon_tpu_torch.fs import FileIO
from paimon_tpu_torch.snapshot.snapshot import Snapshot

__all__ = ["TagManager"]

TAG_PREFIX = "tag-"


class TagManager:
    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path.rstrip("/")

    @property
    def tag_dir(self) -> str:
        return f"{self.table_path}/tag"

    def tag_path(self, name: str) -> str:
        return f"{self.tag_dir}/{TAG_PREFIX}{name}"

    def create_tag(self, snapshot: Snapshot, name: str,
                   ignore_if_exists: bool = False,
                   time_retained_ms=None):
        """`time_retained_ms`: the tag self-expires after this age
        (reference tag/Tag.java tagCreateTime + tagTimeRetained; the
        expiry sweep is `expire_tags`)."""
        if self.tag_exists(name):
            if ignore_if_exists:
                return
            raise ValueError(f"Tag {name!r} already exists")
        payload = snapshot.to_json()
        if time_retained_ms is not None:
            import json as _json
            import time as _time
            d = _json.loads(payload)
            d["tagCreateTime"] = int(_time.time() * 1000)
            d["tagTimeRetained"] = int(time_retained_ms)
            payload = _json.dumps(d)
        ok = self.file_io.try_to_write_atomic(
            self.tag_path(name), payload.encode("utf-8"))
        if not ok:
            raise ValueError(f"Tag {name!r} already exists")

    def expire_tags(self, now_ms=None) -> list:
        """Delete tags whose tagCreateTime + tagTimeRetained has
        passed; returns the names removed (reference
        TagTimeExpire.java)."""
        import json as _json
        import time as _time
        now_ms = now_ms if now_ms is not None else int(_time.time()
                                                       * 1000)
        removed = []
        for st in self.file_io.list_status(self.tag_dir):
            fname = st.path.rstrip("/").split("/")[-1]
            if not fname.startswith(TAG_PREFIX):
                continue
            name = fname[len(TAG_PREFIX):]
            try:
                d = _json.loads(self.file_io.read_utf8(
                    self.tag_path(name)))
            except (FileNotFoundError, OSError, ValueError):
                continue
            created = d.get("tagCreateTime")
            retained = d.get("tagTimeRetained")
            if created is not None and retained is not None and \
                    created + retained <= now_ms:
                self.delete_tag(name)
                removed.append(name)
        return removed

    def rename_tag(self, old: str, new: str):
        """Byte-preserving rename (reference TagManager.renameTag) —
        keeps tagCreateTime/tagTimeRetained, which a parse-and-rewrite
        would drop."""
        if not self.tag_exists(old):
            raise FileNotFoundError(f"Tag {old!r} not found")
        if self.tag_exists(new):
            raise ValueError(f"Tag {new!r} already exists")
        if not self.file_io.rename(self.tag_path(old),
                                   self.tag_path(new)):
            raise RuntimeError(f"renaming tag {old!r} failed")

    def delete_tag(self, name: str):
        self.file_io.delete_quietly(self.tag_path(name))

    def tag_exists(self, name: str) -> bool:
        return self.file_io.exists(self.tag_path(name))

    def get_tag(self, name: str) -> Snapshot:
        return Snapshot.from_json(self.file_io.read_utf8(self.tag_path(name)))

    def tags(self) -> Dict[str, Snapshot]:
        out = {}
        for st in self.file_io.list_status(self.tag_dir):
            fname = st.path.rstrip("/").split("/")[-1]
            if fname.startswith(TAG_PREFIX):
                name = fname[len(TAG_PREFIX):]
                out[name] = self.get_tag(name)
        return dict(sorted(out.items(), key=lambda kv: kv[1].id))

    def tagged_snapshots(self) -> List[Snapshot]:
        return list(self.tags().values())
