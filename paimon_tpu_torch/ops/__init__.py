"""Device compute of the merge plane, in PyTorch.

Counterpart of paimon_tpu/ops/: normalized-key lanes (normkey), the
k-way sorted-run merge as one stable device sort plus a segmented
winner-select (merge, merge_stream), offset-value codes (ovc), the
hand-written CUDA kernel with its plain version (kernels), the
aggregation and partial-update engines over segment reductions (agg)
and the cardinality sketches they merge (sketch).
"""

from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder  # noqa: F401
from paimon_tpu_torch.ops.merge import merge_runs, MergeResult  # noqa: F401
