"""Table API (user-facing): counterpart of paimon_tpu/table/.

reference: paimon-core/.../table/ (FileStoreTable, ReadBuilder,
BatchWriteBuilder, TableWriteImpl, TableCommitImpl).
"""

from paimon_tpu_torch.table.table import (  # noqa: F401
    FileStoreTable, BatchWriteBuilder, StreamWriteBuilder, ReadBuilder,
    TableWrite, TableCommit, TableRead, TableScan,
)
from paimon_tpu_torch.table.stream_scan import DataTableStreamScan  # noqa: F401
