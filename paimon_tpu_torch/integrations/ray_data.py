"""Ray Datasets adapter (reference pypaimon/ray/ray_paimon.py).

Counterpart of paimon_tpu/integrations/ray_data.py.

Ray is an optional dependency, so the adapter is import-gated: the
split-level plumbing (plan -> per-split Arrow read tasks) is plain
Python and unit-testable; the final `ray.data.Dataset` construction
needs ray installed.
"""

from typing import Any, Dict, List, Optional


def _require_ray():
    try:
        import ray  # noqa: F401
        import ray.data  # noqa: F401
        return ray
    except ImportError as e:
        raise ImportError(
            "ray is not installed; `pip install 'ray[data]'` to use "
            "paimon_tpu_torch.integrations.ray_data") from e


def split_read_tasks(table, projection: Optional[List[str]] = None,
                     predicate=None) -> List[Dict[str, Any]]:
    """One task descriptor per split: {'fn': zero-arg callable -> Arrow
    table, 'num_rows': hint}.  This is the engine-agnostic core the Ray
    datasource maps over its workers (Ray owns cross-split parallelism
    there, so each task is a single serial split read)."""
    rb = table.new_read_builder()
    if projection:
        rb = rb.with_projection(projection)
    if predicate is not None:
        rb = rb.with_filter(predicate)
    plan = rb.new_scan().plan()

    tasks = []
    for split in plan.splits:
        def fn(split=split, rb=rb):
            return rb.new_read().read_split(split)

        tasks.append({
            "fn": fn,
            "num_rows": sum(f.row_count for f in split.data_files),
        })
    return tasks


def scan_batches(table, projection: Optional[List[str]] = None,
                 predicate=None, ordered: bool = True):
    """Yield per-split Arrow tables through the pipelined scan executor
    (parallel/scan_pipeline.py) — the in-process counterpart of
    `split_read_tasks` for engines that don't bring their own scheduler
    (daft handoff, plain python consumers)."""
    rb = table.new_read_builder()
    if projection:
        rb = rb.with_projection(projection)
    if predicate is not None:
        rb = rb.with_filter(predicate)
    plan = rb.new_scan().plan()
    read = rb.new_read()
    for _, _, t in read.iter_splits(plan.splits, ordered=ordered):
        yield t


def to_ray_dataset(table, projection: Optional[List[str]] = None,
                   predicate=None, parallelism: int = -1):
    """`ray.data.Dataset` over the table: each split becomes one read
    task scheduled by Ray (reference ray_paimon.read_paimon)."""
    ray = _require_ray()
    tasks = split_read_tasks(table, projection, predicate)
    if not tasks:
        import pyarrow as pa
        return ray.data.from_arrow(
            pa.Table.from_pylist([], schema=table.arrow_schema()))
    ds = ray.data.from_items([i for i in range(len(tasks))],
                             override_num_blocks=len(tasks)
                             if parallelism < 0 else parallelism)
    return ds.map_batches(
        lambda batch: tasks[int(batch["item"][0])]["fn"](),
        batch_size=1, batch_format="numpy")
