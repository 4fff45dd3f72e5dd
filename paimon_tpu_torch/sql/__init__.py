"""SQL layer: a from-scratch SQL front-end over the catalog/table API.

The reference exposes SQL through a native DataFusion binding
(paimon-python/pypaimon/sql/__init__.py -> pypaimon_rust.datafusion
.SQLContext) and through Flink/Spark SQL on the JVM side.  This module
provides the same capability natively: a hand-rolled parser
(`sql/parser.py`) and an Arrow-compute executor (`sql/executor.py`) with
predicate pushdown into table scans, aggregation, equi-joins, time
travel, DDL/DML, and CALL procedures for maintenance actions.
"""

from paimon_tpu_torch.sql.executor import SQLContext  # noqa: F401
