"""Prometheus text exposition of the metric registry (GET /metrics).

Counterpart of the Prometheus half of paimon_tpu/obs/export.py; the
Chrome trace half lives in obs/trace.py (`export_chrome_trace`).  It
renders from `MetricRegistry.snapshot_rows()`, the one serialization of
the registry, so the endpoint and `snapshot()` cannot disagree.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

__all__ = ["render_prometheus"]

# -- Prometheus text exposition ---------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(group: str, metric: str) -> str:
    return _NAME_RE.sub("_", f"paimon_{group}_{metric}")


def _prom_labels(table: str) -> str:
    if not table:
        return ""
    esc = table.replace("\\", "\\\\").replace('"', '\\"')
    return '{table="' + esc + '"}'


def _fmt(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus(rows: Optional[List[Dict]] = None) -> str:
    """Prometheus text exposition (format 0.0.4) of the registry.

    Counters/gauges map 1:1; histograms render as summaries — the p95
    quantile comes from the sliding window, while `_sum`/`_count` are
    the histogram's CUMULATIVE totals (monotonic, as rate()/increase()
    require; window-derived values would cap at the window size) —
    plus a `_max` gauge over the window.  Rows that carry cumulative
    `buckets` additionally render a REAL `le`-bucket histogram family
    under `<base>_hist` (0.0.4 forbids mixing summary and histogram
    samples in one family, and the summary name is the compatibility
    surface), so an external Prometheus can pool
    `histogram_quantile(0.99, sum by (le) (rate(..._hist_bucket[5m])))`
    across replicas — per-replica quantiles can't be aggregated, shared
    fixed buckets can.  `rows` defaults to
    `global_registry().snapshot_rows()`, THE shared serialization
    point.
    """
    if rows is None:
        from paimon_tpu_torch.metrics import global_registry
        rows = global_registry().snapshot_rows()
    # family name -> (kind, [(labels, line-suffix, value)])
    families: Dict[str, List] = {}
    kinds: Dict[str, str] = {}
    for r in rows:
        labels = _prom_labels(r.get("table", ""))
        if r["kind"] == "histogram":
            base = _prom_name(r["group"], r["metric"])
            kinds[base] = "summary"
            fam = families.setdefault(base, [])
            q = '{quantile="0.95"}' if not labels else \
                labels[:-1] + ',quantile="0.95"}'
            fam.append((base + q, r["p95"]))
            fam.append((base + "_sum" + labels,
                        r.get("total_sum", r["mean"] * r["count"])))
            fam.append((base + "_count" + labels,
                        r.get("total_count", r["count"])))
            mx = base + "_max"
            kinds[mx] = "gauge"
            families.setdefault(mx, []).append((mx + labels, r["max"]))
            if r.get("buckets"):
                hist = base + "_hist"
                kinds[hist] = "histogram"
                hf = families.setdefault(hist, [])
                for bound, n in r["buckets"]:
                    le = "+Inf" if bound == float("inf") \
                        else _fmt(bound)
                    lb = '{le="%s"}' % le if not labels else \
                        labels[:-1] + ',le="%s"}' % le
                    hf.append((hist + "_bucket" + lb, n))
                hf.append((hist + "_sum" + labels,
                           r.get("total_sum", 0.0)))
                hf.append((hist + "_count" + labels,
                           r.get("total_count", 0)))
        else:
            name = _prom_name(r["group"], r["metric"])
            kinds[name] = "counter" if r["kind"] == "counter" else "gauge"
            families.setdefault(name, []).append(
                (name + labels, r["value"]))
    lines: List[str] = []
    for fam in sorted(families):
        lines.append(f"# TYPE {fam} {kinds[fam]}")
        for series, value in families[fam]:
            lines.append(f"{series} {_fmt(value)}")
    return "\n".join(lines) + ("\n" if lines else "")
