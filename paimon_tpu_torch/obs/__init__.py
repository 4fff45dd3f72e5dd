"""Observability: span tracing (trace.py), the flight recorder's event
ring (flight.py), SLO burn rates (slo.py) and the Prometheus text of
the metric registry (export.py).

Counterpart of paimon_tpu/obs/; the fleet trace merge (merge.py),
flight dumps and the router's SLO rollup are not ported yet (ROADMAP.md
A.7b).
"""
