"""Path layout factory.

reference: paimon-core/.../utils/FileStorePathFactory.java:55-240 and the
on-disk layout in SURVEY.md §2.9 / docs spec:

  <table>/<k1=v1/k2=v2/...>/bucket-<b>/data-<uuid>-<n>.<ext>
  <table>/manifest/, snapshot/, schema/, index/, statistics/, changelog/
"""

from __future__ import annotations

import itertools
import uuid
from typing import Any, List, Optional, Sequence, Tuple

__all__ = ["FileStorePathFactory"]

DEFAULT_PARTITION_NAME = "__DEFAULT_PARTITION__"


class FileStorePathFactory:
    def __init__(self, table_path: str, partition_keys: Sequence[str],
                 default_partition_name: str = DEFAULT_PARTITION_NAME,
                 data_file_prefix: str = "data-",
                 changelog_file_prefix: str = "changelog-",
                 data_file_dir: str = None):
        self.table_path = table_path.rstrip("/")
        self.partition_keys = list(partition_keys)
        self.default_partition_name = default_partition_name
        self.data_file_prefix = data_file_prefix
        self.changelog_file_prefix = changelog_file_prefix
        # data-file.path-directory: data files live under this subdir
        # of the table path (metadata stays at the root)
        self.data_file_dir = (data_file_dir or "").strip("/") or None
        self._write_uuid = str(uuid.uuid4())
        # itertools.count.__next__ is atomic under the GIL:
        # file-name allocation is shared by concurrent writer
        # threads (streamed compaction's flush pool)
        self._counter = itertools.count()

    @classmethod
    def from_options(cls, table_path: str, partition_keys: Sequence[str],
                     options) -> "FileStorePathFactory":
        """Construct honoring partition.default-name, data-file.prefix,
        changelog-file.prefix and data-file.path-directory — the single
        builder every store plane uses so the layout options apply
        consistently (reference FileStorePathFactory construction in
        AbstractFileStore)."""
        from paimon_tpu_torch.options import CoreOptions
        pf = cls(
            table_path, partition_keys,
            options.get(CoreOptions.PARTITION_DEFAULT_NAME),
            data_file_prefix=options.get(CoreOptions.DATA_FILE_PREFIX),
            changelog_file_prefix=options.get(
                CoreOptions.CHANGELOG_FILE_PREFIX),
            data_file_dir=options.get(
                CoreOptions.DATA_FILE_PATH_DIRECTORY))
        pf.set_external_paths(
            options.get(CoreOptions.DATA_FILE_EXTERNAL_PATHS),
            options.get(CoreOptions.DATA_FILE_EXTERNAL_PATHS_STRATEGY),
            options.get(CoreOptions.DATA_FILE_EXTERNAL_PATHS_SPECIFIC_FS))
        return pf

    # -- dirs ----------------------------------------------------------------

    @property
    def manifest_dir(self) -> str:
        return f"{self.table_path}/manifest"

    @property
    def snapshot_dir(self) -> str:
        return f"{self.table_path}/snapshot"

    @property
    def schema_dir(self) -> str:
        return f"{self.table_path}/schema"

    @property
    def index_dir(self) -> str:
        return f"{self.table_path}/index"

    @property
    def statistics_dir(self) -> str:
        return f"{self.table_path}/statistics"

    @property
    def changelog_dir(self) -> str:
        return f"{self.table_path}/changelog"

    # -- partitions ----------------------------------------------------------

    def partition_path(self, partition: Sequence[Any]) -> str:
        """'k1=v1/k2=v2' spec string (reference PartitionPathUtils)."""
        parts = []
        for key, value in zip(self.partition_keys, partition):
            if value is None or (isinstance(value, str)
                                 and not value.strip()):
                v = self.default_partition_name
            else:
                v = str(value)
            parts.append(f"{key}={v}")
        return "/".join(parts)

    def bucket_dir(self, partition: Sequence[Any], bucket: int) -> str:
        pp = self.partition_path(partition)
        root = f"{self.table_path}/{self.data_file_dir}" \
            if self.data_file_dir else self.table_path
        base = f"{root}/{pp}" if pp else root
        if bucket == -2:
            # postpone mode (reference BucketMode.POSTPONE_MODE):
            # un-hashed staging dir, rescaled into real buckets later
            return f"{base}/bucket-postpone"
        return f"{base}/bucket-{bucket}"

    def data_file_path(self, partition: Sequence[Any], bucket: int,
                       file_name: str) -> str:
        return f"{self.bucket_dir(partition, bucket)}/{file_name}"

    # -- external data paths (reference data-file.external-paths +
    # .strategy + .specific-fs: new data files rotate across external
    # storage roots; readers follow DataFileMeta.external_path) --------------

    def set_external_paths(self, paths: Optional[str],
                           strategy: str = "none",
                           specific_fs: Optional[str] = None):
        roots = [p.strip().rstrip("/") for p in (paths or "").split(",")
                 if p.strip()]
        strategy = (strategy or "none").lower()
        if strategy == "specific-fs":
            if not specific_fs:
                raise ValueError(
                    "strategy=specific-fs requires "
                    "data-file.external-paths.specific-fs")
            want = specific_fs.lower().rstrip(":/")
            roots = [r for r in roots
                     if r.split("://", 1)[0].lower() == want]
            if not roots:
                raise ValueError(
                    f"no external path matches fs {specific_fs!r}")
        self._external_roots = roots if strategy != "none" else []
        # start each writer at a uuid-derived offset so independent
        # writers spread across roots instead of all hammering root[0]
        self._external_rr = hash(self._write_uuid) % max(1, len(roots))

    def new_data_file_location(self, partition: Sequence[Any],
                               bucket: int, file_name: str):
        """-> (write_path, external_path_or_None): THE way every data
        file writer resolves its destination, so external-path rotation
        applies uniformly (data, changelog, row-tracking overlays)."""
        external = self.external_data_file_path(partition, bucket,
                                                file_name)
        return (external or self.data_file_path(partition, bucket,
                                                file_name), external)

    def external_data_file_path(self, partition: Sequence[Any],
                                bucket: int, file_name: str
                                ) -> Optional[str]:
        """Next external location for a new data file (round-robin over
        the configured roots, same table-relative layout), or None when
        external paths are not configured."""
        roots = getattr(self, "_external_roots", None)
        if not roots:
            return None
        root = roots[self._external_rr % len(roots)]
        self._external_rr += 1
        rel = self.data_file_path(partition, bucket, file_name)
        if rel.startswith(self.table_path):
            rel = rel[len(self.table_path):].lstrip("/")
        return f"{root}/{rel}"

    # -- file names ----------------------------------------------------------

    def new_data_file_name(self, extension: str = "parquet") -> str:
        n = next(self._counter)
        return f"{self.data_file_prefix}{self._write_uuid}-{n}.{extension}"

    def new_changelog_file_name(self, extension: str = "parquet",
                                prefix: str = None) -> str:
        n = next(self._counter)
        return (f"{prefix or self.changelog_file_prefix}"
                f"{self._write_uuid}-{n}.{extension}")

    def new_index_file_name(self) -> str:
        return f"index-{uuid.uuid4()}-0"

    def index_file_path(self, name: str) -> str:
        return f"{self.index_dir}/{name}"
