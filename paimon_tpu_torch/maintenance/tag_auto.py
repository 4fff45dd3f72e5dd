"""Automatic tag creation at commit time.

reference: paimon-core/src/main/java/org/apache/paimon/tag/
TagAutoManager.java + TagAutoCreation.java — with
`tag.automatic-creation` enabled, each commit checks whether a tag
period (daily/hourly, or a custom duration) has completed; the first
snapshot past `period end + tag.creation-delay` is tagged with the
period's formatted name, `tag.automatic-completion` backfills any
missed periods, and `tag.num-retained-max` expires the oldest auto
tags.  `process-time` uses the snapshot's commit time, `watermark` the
snapshot's watermark.  `tag.default-time-retained` stamps an expiry on
every auto tag, `tag.create-success-file` drops a _SUCCESS marker.

A copy of paimon_tpu/maintenance/tag_auto.py (no JAX in it).
"""

from __future__ import annotations

import datetime
import re
from typing import List

from paimon_tpu_torch.options import CoreOptions

__all__ = ["maybe_create_tags"]

# names this module creates: 'YYYY-MM-DD', 'YYYY-MM-DD HH', or the
# dash-less variants — ONLY these are subject to auto-tag expiry
_AUTO_TAG_RE = re.compile(r"^\d{4}-\d{2}-\d{2}( \d{2})?$|^\d{8}(\d{2})?$")


def _list_tag_names(table) -> List[str]:
    """Tag names without reading each tag's snapshot file."""
    from paimon_tpu_torch.snapshot.tag_manager import TAG_PREFIX
    try:
        sts = table.file_io.list_status(table.tag_manager.tag_dir)
    except (FileNotFoundError, OSError):
        return []
    out = []
    for st in sts:
        fname = st.path.rstrip("/").split("/")[-1]
        if fname.startswith(TAG_PREFIX):
            out.append(fname[len(TAG_PREFIX):])
    return sorted(out)


def _period_millis(options: CoreOptions) -> int:
    dur = options.get(CoreOptions.TAG_CREATION_PERIOD_DURATION)
    if dur:
        return dur
    period = options.get(CoreOptions.TAG_CREATION_PERIOD)
    return {"daily": 86_400_000, "hourly": 3_600_000,
            "two-hours": 7_200_000}.get(period, 86_400_000)


def _format_period(start_ms: int, period_ms: int,
                   formatter: str) -> str:
    dt = datetime.datetime.fromtimestamp(start_ms / 1000,
                                         tz=datetime.timezone.utc)
    if period_ms >= 86_400_000:
        out = dt.strftime("%Y-%m-%d")
    else:
        out = dt.strftime("%Y-%m-%d %H")
    if formatter.startswith("without_dashes"):
        out = out.replace("-", "").replace(" ", "")
    return out


def maybe_create_tags(table) -> List[str]:
    """Create any due auto tags for the latest snapshot; returns the
    names created.  Call after a successful commit (the reference wires
    TagAutoManager into the commit callback)."""
    options = table.options
    mode = options.get(CoreOptions.TAG_AUTOMATIC_CREATION)
    if mode in (None, "none"):
        return []
    snapshot = table.latest_snapshot()
    if snapshot is None:
        return []
    if mode == "watermark":
        now_ms = snapshot.watermark
        if now_ms is None:
            return []
    else:                                 # process-time
        now_ms = snapshot.time_millis
    period_ms = _period_millis(options)
    delay_ms = options.get(CoreOptions.TAG_CREATION_DELAY)
    formatter = options.get(CoreOptions.TAG_PERIOD_FORMATTER)

    # the latest fully-elapsed period whose (end + delay) has passed
    last_complete = ((now_ms - delay_ms) // period_ms) * period_ms \
        - period_ms
    if last_complete < 0:
        return []
    periods = [last_complete]
    if options.get(CoreOptions.TAG_AUTOMATIC_COMPLETION):
        # backfill every missed period since the newest existing auto
        # tag (reference TagAutoCreation automatic-completion)
        existing = {n for n in _list_tag_names(table)
                    if _AUTO_TAG_RE.match(n)}
        p = last_complete - period_ms
        while p >= 0 and \
                _format_period(p, period_ms, formatter) not in existing:
            periods.append(p)
            p -= period_ms
        periods.reverse()
    created: List[str] = []
    for start in periods:
        name = _format_period(start, period_ms, formatter)
        if table.tag_manager.tag_exists(name):
            continue
        # ignore_if_exists: two committers racing the same period must
        # both see their DATA commit succeed
        table.tag_manager.create_tag(
            snapshot, name, ignore_if_exists=True,
            time_retained_ms=options.get(
                CoreOptions.TAG_DEFAULT_TIME_RETAINED))
        table.fire_tag_callbacks(name, snapshot.id)
        created.append(name)
        if options.get(CoreOptions.TAG_CREATE_SUCCESS_FILE):
            table.file_io.write_bytes(
                f"{table.tag_manager.tag_dir}/{name}._SUCCESS", b"",
                overwrite=True)
    if created:
        _expire_auto_tags(table, options)
    if options.get(CoreOptions.TAG_TIME_EXPIRE_ENABLED):
        table.tag_manager.expire_tags()
    return created


def _expire_auto_tags(table, options: CoreOptions):
    """Only tags MATCHING the auto-naming pattern count toward (and are
    removed by) tag.num-retained-max — manual tags are never touched
    (reference TagAutoCreation expires its own tags only)."""
    retain = options.get(CoreOptions.TAG_NUM_RETAINED_MAX)
    if not retain:
        return
    auto = [n for n in _list_tag_names(table) if _AUTO_TAG_RE.match(n)]
    while len(auto) > retain:
        table.delete_tag(auto.pop(0))
