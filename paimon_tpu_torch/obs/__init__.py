"""Observability: span tracing and per-process spools (trace.py), the
flight recorder's event ring and its dumps (flight.py), the merge of
several processes' spools into one trace (merge.py), SLO burn rates
(slo.py) and the Prometheus text of the metric registry (export.py).

Counterpart of paimon_tpu/obs/; the router's SLO rollup is not ported
yet (ROADMAP.md A.7b).
"""
