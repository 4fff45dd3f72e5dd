"""Observability: span tracing (trace.py) and the flight recorder's
event ring (flight.py).

Counterpart of paimon_tpu/obs/, reduced to what the mesh compaction
plane records; SLOs, fleet merge and the rest of the flight recorder
are not ported yet (ROADMAP.md A.7).
"""
