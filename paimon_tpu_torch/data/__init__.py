"""Data plane (L1).

Rows are plain Python tuples at the edges; columnar batches are Arrow
RecordBatches on the host and torch tensors on the device. The only
row-level binary codec kept from the reference wire format is BinaryRow
(paimon-common/.../data/BinaryRow.java:60), because manifests embed
partitions and min/max stats as BinaryRow bytes.
"""

from paimon_tpu_torch.data.binary_row import (  # noqa: F401
    BinaryRowCodec, BINARY_ROW_EMPTY,
)
from paimon_tpu_torch.data.row import GenericRow, InternalRow  # noqa: F401
