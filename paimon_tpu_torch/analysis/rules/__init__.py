"""Rule catalog: importing this package registers every rule with the
engine.  Grouped by family:

* hygiene  — the seven hygiene lints (swallow, threads,
  sleeps, sockets, collectives, distributed-init,
  host-materialization)
* drift    — metric-name, observability-name and options-doc drift
* locks    — lock-order: inter-procedural lock-acquisition cycles
* eventloop — loop-blocking: blocking primitive reachable from the
  event-loop thread
* deadline — deadline-wait: unbounded blocking waits outside the
  sanctioned bounded forms
* fault    — fault-taxonomy: transient store errors handled outside
  parallel/fault.py's ladder
* ownership — ownership-history: ownership-stamp properties parsed
  outside parallel/distributed.py's stamp/history API
"""

from paimon_tpu_torch.analysis.rules import (  # noqa: F401
    deadline, drift, eventloop, fault, hygiene, locks, ownership,
)
