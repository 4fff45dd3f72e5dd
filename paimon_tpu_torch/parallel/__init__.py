"""Scale-out plane: bucket lanes over a mesh, and the host thread pools
of the write and scan paths.

Counterpart of paimon_tpu/parallel/.  The reference lays buckets over a
jax Mesh axis; here a mesh is a number of bucket lanes merged as one
batch on one torch device, or split over the ranks of a
torch.distributed group (sharded_merge.py).  Every lane merges its
buckets with the same segmented sort and winner-select kernel as the
single-chip path, and commit statistics are summed over the lanes.
"""

from paimon_tpu_torch.parallel.sharded_merge import (  # noqa: F401
    BucketMesh, ShardedBucketMerge, bucket_mesh, merge_buckets_sharded,
    pad_bucket_batches,
)
from paimon_tpu_torch.parallel.sharded_compact import (  # noqa: F401
    ShardedCompactStats, compact_table_sharded,
)
from paimon_tpu_torch.parallel.rescale import (  # noqa: F401
    rescale_dispatch_sharded, rescale_table_buckets,
)
from paimon_tpu_torch.parallel.mesh_engine import (  # noqa: F401
    MeshCompactStats, SUPPORTED_MERGE_ENGINES,
    UnsupportedMergeEngineError, compact_table_mesh,
)
from paimon_tpu_torch.parallel.fault import (  # noqa: F401
    BucketRetryPolicy, is_transient_error,
)
from paimon_tpu_torch.parallel.packing import (  # noqa: F401
    bucket_row_counts, pack_buckets, packing_skew,
)
