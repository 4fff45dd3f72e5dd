"""Maintenance operations: snapshot/partition expiration, orphan cleanup.

Counterpart of paimon_tpu/maintenance/ for primary-key tables: snapshot
and decoupled changelog expiry, orphan clean, fsck and its repairs,
manifest compaction, partition expiry, mark-done and auto-tags; clone
and migrate (clone.py, migrate.py) take a catalog.

reference: operation/SnapshotDeletion.java, ExpireSnapshotsImpl,
operation/OrphanFilesClean.java, operation/PartitionExpire.java.
"""

from paimon_tpu_torch.maintenance.expire import (  # noqa: F401
    ExpireResult, expire_changelogs, expire_snapshots,
)
from paimon_tpu_torch.maintenance.fsck import (  # noqa: F401
    FsckReport, FsckViolation, ViolationKind, fsck,
)
from paimon_tpu_torch.maintenance.repair import fix_violations  # noqa: F401
from paimon_tpu_torch.maintenance.mark_done import (  # noqa: F401
    PartitionMarkDoneTrigger, mark_partitions_done,
)
from paimon_tpu_torch.maintenance.manifest_compact import (  # noqa: F401
    compact_manifests, manifest_compaction_needed,
)
from paimon_tpu_torch.maintenance.orphan import remove_orphan_files  # noqa: F401
from paimon_tpu_torch.maintenance.partition_expire import (  # noqa: F401
    expire_partitions,
)
from paimon_tpu_torch.maintenance.watermark import (  # noqa: F401
    FSCK_WATERMARK_PREFIX, ORPHAN_WATERMARK_PREFIX, SweepWatermark,
    read_watermark, stamp_watermark, validate_watermark,
)
