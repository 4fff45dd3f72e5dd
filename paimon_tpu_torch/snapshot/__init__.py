"""Snapshot subsystem: snapshot JSON files, the snapshot manager,
consumer progress and the read side of decoupled changelog (tags and
branches are not ported yet).

reference: paimon-api/.../Snapshot.java:43, paimon-core/.../utils/
(SnapshotManager, TagManager, BranchManager, ChangelogManager), consumer/.
"""

from paimon_tpu_torch.snapshot.snapshot import Snapshot, CommitKind  # noqa: F401
from paimon_tpu_torch.snapshot.snapshot_manager import SnapshotManager  # noqa: F401
from paimon_tpu_torch.snapshot.consumer_manager import ConsumerManager  # noqa: F401
from paimon_tpu_torch.snapshot.changelog_manager import ChangelogManager  # noqa: F401
