"""LSM compaction subsystem.

reference: paimon-core/.../mergetree/compact/ (UniversalCompaction.java:42,
MergeTreeCompactManager.java:54, MergeTreeCompactTask.java:41,
MergeTreeCompactRewriter.java:47) + compact/CompactManager SPI.
"""

from paimon_tpu_torch.compact.levels import Levels, SortedRun, LevelSortedRun  # noqa: F401
from paimon_tpu_torch.compact.universal import UniversalCompaction, CompactUnit  # noqa: F401
from paimon_tpu_torch.compact.manager import MergeTreeCompactManager  # noqa: F401
from paimon_tpu_torch.compact.compact_action import compact_table  # noqa: F401
