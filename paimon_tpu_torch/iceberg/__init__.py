"""Iceberg compatibility: Iceberg v2 metadata beside a table, so Iceberg
readers open it.

Counterpart of paimon_tpu/iceberg/ (reference: paimon-core/.../iceberg/
IcebergCommitCallback, metadata/ IcebergMetadata JSON, manifest/ avro
manifests, and the paimon-iceberg module's REST committer).  The export
is host metadata; the full compaction a primary-key table needs before
its rows are visible merges on the table's device.
"""

from paimon_tpu_torch.iceberg.metadata import sync_iceberg  # noqa: F401
