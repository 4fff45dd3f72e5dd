"""Daft adapter (reference pypaimon/daft/daft_datasource.py).

Counterpart of paimon_tpu/integrations/daft_data.py.

Daft is an optional dependency; like ray_data, the split plumbing is
shared (`ray_data.split_read_tasks`) and only the DataFrame handoff
needs daft installed.
"""

from typing import List, Optional

from paimon_tpu_torch.integrations.ray_data import scan_batches


def _require_daft():
    try:
        import daft
        return daft
    except ImportError as e:
        raise ImportError(
            "daft is not installed; `pip install daft` to use "
            "paimon_tpu_torch.integrations.daft_data") from e


def to_daft_dataframe(table, projection: Optional[List[str]] = None,
                      predicate=None):
    """daft.DataFrame over the table's current snapshot (reference
    daft_paimon.read_paimon).  Reads the splits into Arrow and hands
    the batches to daft; predicate/projection pushdown happened in the
    paimon scan."""
    daft = _require_daft()
    import pyarrow as pa

    # pipelined split reads (parallel/scan_pipeline.py): splits decode
    # concurrently instead of the previous serial per-task loop
    batches = list(scan_batches(table, projection, predicate))
    if not batches:
        schema = table.arrow_schema()
        if projection:
            schema = pa.schema([schema.field(c) for c in projection])
        return daft.from_arrow(pa.Table.from_pylist([], schema=schema))
    return daft.from_arrow(pa.concat_tables(batches,
                                            promote_options="none"))
