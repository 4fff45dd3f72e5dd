"""CDC ingestion: change-event parsing + schema-evolving sink.

Counterpart of paimon_tpu/cdc/: the parsers, computed columns and
sources are host-only; the sink and the database sync write through the
port's tables, merging on each table's device.

reference: paimon-flink-cdc (action/cdc/: mysql/postgres/kafka sync
actions; format/: debezium, canal, maxwell parsers; sink/cdc/:
CdcRecordStoreMultiWriteOperator applying schema changes through
SchemaManager before writing).
"""

from paimon_tpu_torch.cdc.sink import CdcSinkWriter  # noqa: F401
from paimon_tpu_torch.cdc.database_sync import CdcDatabaseSync  # noqa: F401
from paimon_tpu_torch.cdc.formats import (  # noqa: F401
    parse_canal, parse_debezium, parse_maxwell,
)
from paimon_tpu_torch.cdc.source import (  # noqa: F401
    FileCdcSource, MemoryCdcSource,
)
