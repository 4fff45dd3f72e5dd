"""Fleet trace stitching: merge per-process span spools into one
Perfetto-loadable Chrome trace.

Every process that runs with `trace.export.dir` set appends its spans
to ``<dir>/<process_tag>.jsonl`` (header line with identity + clock
anchor, then one span per line — obs/trace.py `spool_flush`).  This
module reads the whole directory and emits a single trace where:

* each spool file becomes one Chrome trace *process* (pid = file
  index), named after its host/pid/replica via ``process_name``
  metadata, with per-thread tracks inside it exactly like the
  single-process export;
* span timestamps are re-based from each process's private
  perf_counter timeline onto a shared wall-clock timeline using the
  (wall_s, perf_s) anchor pair in the spool header — without this,
  two processes' spans would land at unrelated offsets;
* every cross-boundary reference becomes a Perfetto *flow arrow*:
  a span whose attrs carry ``remote_parent`` (serving hops — the
  X-Parent-Span header) or ``link`` (store-carried context — the
  ``trace.context`` snapshot property) points at a
  ``<process_tag>:<span_id>`` token; if the referenced span is present
  in any spool, an "s"/"f" flow-event pair ties the two tracks
  together at the boundary.

`python -m paimon_tpu_torch fleet trace --merge <dir>` is the CLI
entry.  Counterpart of paimon_tpu/obs/merge.py; it reads the spools of
either package the same way.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["read_spools", "merge_spools", "export_merged"]

# Spool span attrs that reference a span in another process, in
# "<process_tag>:<span_id>" token form.
_REF_ATTRS = ("remote_parent", "link")


def read_spools(directory: str) -> List[Dict]:
    """Parse every ``*.jsonl`` spool in `directory` into
    ``{"meta": <header dict>, "spans": [<span dict>, ...]}`` entries,
    sorted by process tag for a deterministic merge.  Files without a
    valid header line are skipped (a process that died before its
    first flush leaves nothing useful)."""
    procs: List[Dict] = []
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".jsonl"):
            continue
        path = os.path.join(directory, fname)
        meta: Optional[Dict] = None
        spans: List[Dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue      # torn tail line from a killed writer
                if meta is None:
                    if "proc" not in rec:
                        break     # not a spool file
                    meta = rec
                elif "sid" in rec:
                    spans.append(rec)
        if meta is not None:
            procs.append({"meta": meta, "spans": spans})
    procs.sort(key=lambda p: p["meta"]["proc"])
    return procs


def _proc_label(meta: Dict) -> str:
    label = f"{meta.get('host', '?')}/{meta.get('pid', '?')}"
    if meta.get("replica"):
        label += f" [{meta['replica']}]"
    return label


def merge_spools(procs: List[Dict]) -> Tuple[Dict, Dict]:
    """Build the merged Chrome trace object plus a stats dict
    ``{"processes", "spans", "flows", "unresolved"}`` from parsed
    spools.  `unresolved` counts cross-boundary references whose
    source span was not found in any spool (evicted from its ring or
    the process never flushed) — the arrow is simply omitted."""
    events: List[Dict] = []
    # token "<proc>:<sid>" -> (pid, tid, start_ts_us) of the source
    # span; arrows leave from the source's START (a client span
    # strictly encloses the server span it spawned, so its end would
    # point backwards in time)
    by_token: Dict[str, Tuple[int, int, float]] = {}
    # (pid, ref attr, token, start_ts_us, tid) per referencing span
    refs: List[Tuple[int, str, str, float, int]] = []
    n_spans = 0

    for pid, proc in enumerate(procs, start=1):
        meta = proc["meta"]
        tag = meta["proc"]
        # perf_counter -> wall rebase: wall_us(ts) = ts + base_us
        base_us = (meta.get("wall_s", 0.0) - meta.get("perf_s", 0.0)) \
            * 1e6
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": _proc_label(meta)}})
        track_ids: Dict[Tuple, int] = {}
        track_names: Dict[int, str] = {}
        for s in proc["spans"]:
            tid = track_ids.setdefault((s.get("thread"), s.get("tid")),
                                       len(track_ids) + 1)
            track_names[tid] = s.get("thread") or f"thread-{s['tid']}"
            ts = s["ts"] + base_us
            attrs = s.get("attrs") or {}
            events.append({
                "name": s["name"], "cat": s.get("cat") or "span",
                "ph": "X", "ts": round(ts, 3),
                "dur": round(max(s.get("dur", 0.0), 0.001), 3),
                "pid": pid, "tid": tid, "args": attrs,
            })
            n_spans += 1
            by_token[f"{tag}:{s['sid']}"] = (pid, tid, ts + 0.001)
            for key in _REF_ATTRS:
                tok = attrs.get(key)
                if tok:
                    refs.append((pid, key, tok, ts, tid))
        for tid, name in track_names.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})

    flows = unresolved = 0
    for dst_pid, key, tok, dst_ts, dst_tid in refs:
        src = by_token.get(tok)
        if src is None:
            unresolved += 1
            continue
        src_pid, src_tid, src_ts = src
        flows += 1
        fid = flows
        # Perfetto pairs "s"/"f" by (cat, name, id); binding point "e"
        # attaches the arrow head to the enclosing slice.
        events.append({"ph": "s", "id": fid, "pid": src_pid,
                       "tid": src_tid, "ts": round(src_ts, 3),
                       "name": key, "cat": "flow"})
        events.append({"ph": "f", "bp": "e", "id": fid, "pid": dst_pid,
                       "tid": dst_tid,
                       "ts": round(max(dst_ts + 0.001, src_ts), 3),
                       "name": key, "cat": "flow"})

    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    stats = {"processes": len(procs), "spans": n_spans,
             "flows": flows, "unresolved": unresolved}
    return trace, stats


def export_merged(directory: str, out_path: str) -> Dict:
    """Merge every spool under `directory` into one Perfetto file at
    `out_path`; returns the merge stats."""
    procs = read_spools(directory)
    trace, stats = merge_spools(procs)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    stats["out"] = out_path
    return stats
