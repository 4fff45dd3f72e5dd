"""Snapshot subsystem: snapshot JSON files and the snapshot manager
(tags, branches and consumers are not ported yet).

reference: paimon-api/.../Snapshot.java:43, paimon-core/.../utils/
(SnapshotManager, TagManager, BranchManager, ChangelogManager), consumer/.
"""

from paimon_tpu_torch.snapshot.snapshot import Snapshot, CommitKind  # noqa: F401
from paimon_tpu_torch.snapshot.snapshot_manager import SnapshotManager  # noqa: F401
