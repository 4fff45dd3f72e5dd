"""Point-lookup plane.

Counterpart of paimon_tpu/lookup/.  reference: mergetree/
LookupLevels.java:56 (lookup:137), table/query/LocalTableQuery.java:69.
"""

from paimon_tpu_torch.lookup.local_query import LocalTableQuery  # noqa: F401
