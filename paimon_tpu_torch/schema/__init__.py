"""Schema subsystem: user-facing Schema, versioned TableSchema files, and
SchemaManager (DDL + schema evolution).

reference: paimon-core/.../schema/ (TableSchema.java, SchemaManager.java,
SchemaChange.java, SchemaEvolutionUtil.java), spec docs/concepts/spec/schema.md.
"""

from paimon_tpu_torch.schema.schema import Schema  # noqa: F401
from paimon_tpu_torch.schema.table_schema import TableSchema  # noqa: F401
from paimon_tpu_torch.schema.schema_manager import (  # noqa: F401
    SchemaChange, SchemaManager,
)
