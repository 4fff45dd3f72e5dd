"""Manifest metadata layer (avro object files).

reference: paimon-core/.../manifest/ (ManifestEntry, ManifestFile,
ManifestList, IndexManifestFile, SimpleStats, FileEntry merge logic);
spec docs/docs/concepts/spec/manifest.md.
"""

from paimon_tpu_torch.manifest.simple_stats import SimpleStats  # noqa: F401
from paimon_tpu_torch.manifest.data_file_meta import DataFileMeta, FileSource  # noqa: F401
from paimon_tpu_torch.manifest.manifest_entry import (  # noqa: F401
    FileKind, ManifestEntry, merge_manifest_entries,
)
from paimon_tpu_torch.manifest.manifest_file import (  # noqa: F401
    ManifestFile, ManifestFileMeta, ManifestList,
)
from paimon_tpu_torch.manifest.index_manifest import (  # noqa: F401
    IndexFileMeta, IndexManifestEntry, IndexManifestFile,
)
