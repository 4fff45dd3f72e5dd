"""Declarative SLOs evaluated as multi-window burn rates.

Counterpart of paimon_tpu/obs/slo.py.  An objective such as "99.9% of
requests succeed" or "99% finish under 250 ms" becomes a burn rate: the
observed bad-event rate over the error budget 1 - target.  The alert
fires only when a fast and a slow window both burn above the threshold
(multi-window multi-burn-rate alerting).  Each query server feeds one
evaluator per response and serves it at GET /slo; `evaluate()` also
refreshes the `slo` metric group.  The replica router folds the
replicas' documents with `aggregate_slo` (the worst burn wins).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from paimon_tpu_torch.metrics import (
    SLO_ALERT, SLO_AVAILABILITY_BURN_FAST, SLO_AVAILABILITY_BURN_SLOW,
    SLO_BAD_EVENTS, SLO_GOOD_EVENTS, SLO_LATENCY_BURN_FAST,
    SLO_LATENCY_BURN_SLOW,
)

__all__ = ["SloConfig", "SloEvaluator", "aggregate_slo"]

# Availability bad-events: everything the objective's user would call
# a failed request — load-shed (429) and server errors including
# deadline 504s.  4xx caller mistakes don't spend the server's budget.
_BAD_STATUS_FLOOR = 500
_BAD_STATUS_EXTRA = (429,)

MAX_EVENTS = 65536


class SloConfig:
    """Parsed `service.slo.*` options with the declared objectives."""

    def __init__(self, enabled: bool = True,
                 availability_target: float = 0.999,
                 latency_p99_ms: float = 250.0,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_threshold: float = 2.0):
        self.enabled = enabled
        self.availability_target = min(max(availability_target, 0.0),
                                       0.999999)
        self.latency_p99_ms = latency_p99_ms
        self.fast_window_s = fast_window_s
        self.slow_window_s = max(slow_window_s, fast_window_s)
        self.burn_threshold = burn_threshold

    @classmethod
    def from_options(cls, options) -> "SloConfig":
        from paimon_tpu_torch.options import CoreOptions
        o = options.options if hasattr(options, "options") else options
        return cls(
            enabled=o.get(CoreOptions.SERVICE_SLO_ENABLED),
            availability_target=o.get(
                CoreOptions.SERVICE_SLO_AVAILABILITY_TARGET),
            latency_p99_ms=o.get(CoreOptions.SERVICE_SLO_LATENCY_P99_MS),
            fast_window_s=o.get(CoreOptions.SERVICE_SLO_FAST_WINDOW_S),
            slow_window_s=o.get(CoreOptions.SERVICE_SLO_SLOW_WINDOW_S),
            burn_threshold=o.get(
                CoreOptions.SERVICE_SLO_BURN_THRESHOLD))


class SloEvaluator:
    """Per-replica burn-rate evaluator fed one (status, duration)
    pair per served request.  `clock` is injectable so storm tests can
    march time instead of sleeping."""

    def __init__(self, config: Optional[SloConfig] = None,
                 table: str = "", clock=time.monotonic):
        self.config = config or SloConfig()
        self._clock = clock
        self._lock = threading.Lock()
        # (t, ok, over_latency) per request, oldest first
        self._events: deque = deque(maxlen=MAX_EVENTS)
        self._good = 0
        self._bad = 0
        from paimon_tpu_torch.metrics import global_registry
        g = global_registry().slo_metrics(table)
        self._g_av_fast = g.gauge(SLO_AVAILABILITY_BURN_FAST)
        self._g_av_slow = g.gauge(SLO_AVAILABILITY_BURN_SLOW)
        self._g_lat_fast = g.gauge(SLO_LATENCY_BURN_FAST)
        self._g_lat_slow = g.gauge(SLO_LATENCY_BURN_SLOW)
        self._g_alert = g.gauge(SLO_ALERT)
        self._c_good = g.counter(SLO_GOOD_EVENTS)
        self._c_bad = g.counter(SLO_BAD_EVENTS)

    def observe(self, status: int, dur_ms: float) -> None:
        if not self.config.enabled:
            return
        ok = status < _BAD_STATUS_FLOOR and \
            status not in _BAD_STATUS_EXTRA
        over = dur_ms > self.config.latency_p99_ms
        now = self._clock()
        horizon = now - self.config.slow_window_s
        with self._lock:
            self._events.append((now, ok, over))
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()
            if ok:
                self._good += 1
            else:
                self._bad += 1
        (self._c_good if ok else self._c_bad).inc()

    @staticmethod
    def _burn(bad: int, total: int, budget: float) -> float:
        if total == 0:
            return 0.0
        return (bad / total) / budget

    def evaluate(self) -> Dict:
        """Burn rates + alert state now; also refreshes the `slo`
        metric gauges so a scrape and this dict can't disagree."""
        cfg = self.config
        now = self._clock()
        with self._lock:
            events = list(self._events)
        win: Dict[str, List] = {
            "fast": [e for e in events
                     if e[0] >= now - cfg.fast_window_s],
            "slow": [e for e in events
                     if e[0] >= now - cfg.slow_window_s],
        }
        av_budget = 1.0 - cfg.availability_target
        lat_budget = 0.01          # latency objective is a p99
        burns = {}
        for wname, evs in win.items():
            total = len(evs)
            burns["availability_" + wname] = self._burn(
                sum(1 for e in evs if not e[1]), total, av_budget)
            burns["latency_" + wname] = self._burn(
                sum(1 for e in evs if e[2]), total, lat_budget)
        thr = cfg.burn_threshold
        av_alert = burns["availability_fast"] >= thr and \
            burns["availability_slow"] >= thr
        lat_alert = burns["latency_fast"] >= thr and \
            burns["latency_slow"] >= thr
        alert = av_alert or lat_alert
        self._g_av_fast.set(burns["availability_fast"])
        self._g_av_slow.set(burns["availability_slow"])
        self._g_lat_fast.set(burns["latency_fast"])
        self._g_lat_slow.set(burns["latency_slow"])
        self._g_alert.set(1.0 if alert else 0.0)
        return {
            "enabled": cfg.enabled,
            "objectives": {
                "availability": {
                    "target": cfg.availability_target,
                    "burn_fast": round(burns["availability_fast"], 4),
                    "burn_slow": round(burns["availability_slow"], 4),
                    "alert": av_alert,
                },
                "latency": {
                    "p99_ms": cfg.latency_p99_ms,
                    "burn_fast": round(burns["latency_fast"], 4),
                    "burn_slow": round(burns["latency_slow"], 4),
                    "alert": lat_alert,
                },
            },
            "windows_s": {"fast": cfg.fast_window_s,
                          "slow": cfg.slow_window_s},
            "burn_threshold": thr,
            "alert": alert,
            "good_events": self._good,
            "bad_events": self._bad,
        }


def aggregate_slo(per_replica: Dict[str, Dict]) -> Dict:
    """Fleet rollup of per-replica `/slo` documents (router): the
    fleet burn for each objective is the WORST replica's burn (an SLO
    is violated wherever any user lands), the alert is the OR, and
    event counts sum.  Replicas that failed to answer are listed in
    `unreachable` instead of poisoning the rollup."""
    worst = {"availability": {"burn_fast": 0.0, "burn_slow": 0.0},
             "latency": {"burn_fast": 0.0, "burn_slow": 0.0}}
    alert = False
    good = bad = 0
    reachable = {}
    unreachable = []
    for rid, doc in sorted(per_replica.items()):
        if not isinstance(doc, dict) or "objectives" not in doc:
            unreachable.append(rid)
            continue
        reachable[rid] = doc
        alert = alert or bool(doc.get("alert"))
        good += int(doc.get("good_events", 0))
        bad += int(doc.get("bad_events", 0))
        for obj in ("availability", "latency"):
            for w in ("burn_fast", "burn_slow"):
                v = float(doc["objectives"][obj].get(w, 0.0))
                worst[obj][w] = max(worst[obj][w], v)
    return {
        "replicas": len(reachable),
        "unreachable": unreachable,
        "alert": alert,
        "objectives": worst,
        "good_events": good,
        "bad_events": bad,
        "per_replica": reachable,
    }
