"""deadline-wait: every blocking wait must be bounded.

End-to-end deadlines are the request plane's defense against
slowness: every blocking wait caps itself to the remaining budget
(`utils/deadline.py`, `utils/backoff.py`).  That contract only holds
if NO unbounded wait exists outside the sanctioned forms — one
`Event.wait()` with no timeout and a timed-out request (or a whole
worker) is parked forever behind a build that died.

This rule flags every unbounded blocking wait (per rules/blocking.py:
zero-arg `.wait()`, module-level `cf.wait(fs)` without `timeout=`,
zero-arg `.result()`, blocking queue `.get()` without timeout,
zero-arg `.join()`) outside the whitelisted wait-owning modules:

* utils/deadline.py / utils/backoff.py — the bounded forms themselves;
* parallel/executors.py — pool plumbing whose joins are
  shutdown-owned.

What "bounded" means here is syntactic (a timeout argument is
present); whether the timeout DERIVES from the deadline is the wait
loop's job — the idiom is `wait(0.5)` in a loop that calls
`check_deadline()` (see parallel/write_pipeline.py) or
`result(timeout=dl.remaining_s())` (see parallel/scan_pipeline.py).

A worker's IDLE dispatch wait (a daemon thread parked on its own inbox
with nothing to do and nothing waiting on it) is the legitimate
exemption shape — suppress at the site with the reason.  Lock
acquisitions are deliberately out of scope (the lock-order rule owns
lock risk; flagging every `with lock:` would drown the signal).
"""

from __future__ import annotations

from typing import List

from paimon_tpu_torch.analysis.engine import Finding, rule
from paimon_tpu_torch.analysis.model import ProgramModel
from paimon_tpu_torch.analysis.rules.blocking import iter_blocking_sites

_WHITELIST = frozenset({
    "utils/deadline.py", "utils/backoff.py", "parallel/executors.py",
})

_FIX = {
    "wait": "pass a timeout and loop with check_deadline(), or use "
            "utils.backoff.wait_for()",
    "future-result": "use .result(timeout=...) — derive it from "
                     "current_deadline().remaining_s() when a request "
                     "is in scope",
    "queue-get": "use .get(timeout=...) in a loop that calls "
                 "check_deadline()",
    "join": "pass a timeout and handle the still-alive case",
}


@rule("deadline-wait",
      "unbounded blocking wait outside the deadline-aware forms")
def check_deadline_wait(model: ProgramModel) -> List[Finding]:
    out: List[Finding] = []
    for fn in model.functions.values():
        mod = fn.module
        if mod.pkg_rel in _WHITELIST:
            continue
        for site in iter_blocking_sites(model, fn):
            if site.bounded or site.kind in ("lock", "sleep",
                                             "file-io"):
                continue
            out.append(Finding(
                "deadline-wait", mod.rel, site.line,
                f"unbounded {site.kind} ({site.detail}) in "
                f"{fn.qname} — a spent request deadline cannot "
                f"escape this wait: {_FIX.get(site.kind, 'bound it')}"))
    return out
