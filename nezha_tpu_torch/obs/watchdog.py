"""Anomaly watchdog: window views -> typed ``events.jsonl`` records.

A :class:`Watchdog` runs one ``check()`` per interval (a daemon thread
in the serve CLI, wired by ``--watchdog-interval``/``--slo``) and
turns raw windows into the typed event stream later scheduling /
autoscaling PRs consume (ROADMAP open item 2). Rules, each pinned as an
event kind in the telemetry schema:

==============================  =======================================
``watchdog.queue_depth_sustained``  ``serve.queue_depth`` min over the
                                    window >= limit — the queue never
                                    drained for a full window.
``watchdog.ttft_regression``        windowed ``serve.ttft_s`` p99 vs
                                    the TRAILING baseline (the older
                                    300s view, current window excluded)
                                    exceeds the regression factor.
``watchdog.replica_flap``           ``router.replica_restarts_total``
                                    delta over the window >= limit.
``watchdog.slo_burn``               an :class:`~nezha_tpu_torch.obs.slo.
                                    SLOTracker` burn rate >= the alert
                                    threshold.
``slo.eval``                        one info record per SLO evaluation
                                    (the offline compliance stream
                                    ``nezha-telemetry --slo`` renders).
==============================  =======================================

Alert-kind rules fire on the RISING EDGE (condition false -> true) and
re-arm only after the condition clears, so a sustained incident is one
event, not one per check. Every check also maintains the pinned
``watchdog.*``/``slo.*`` instruments (checks/events counters, max burn
rate gauge) so the watchdog's own behavior is visible in ``/metrics``.
"""

from __future__ import annotations

import threading
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence

from nezha_tpu_torch.obs import registry as _registry
from nezha_tpu_torch.obs.slo import SLOConfig, SLOTracker, evaluate_slo


@dataclass(frozen=True)
class WatchdogConfig:
    """Threshold/trend knobs."""

    interval_s: float = 10.0          # check cadence
    window_s: float = 60.0            # rule evaluation window
    baseline_window_s: float = 300.0  # trailing-baseline span
    queue_depth_limit: float = 16.0   # sustained-queue threshold
    ttft_regression_factor: float = 2.0   # current p99 vs baseline p99
    min_samples: int = 8              # TTFT counts below this: no verdict
    flap_limit: float = 3.0           # replica restarts per window
    burn_alert: float = 2.0           # SLOTracker.burn_rate() threshold


class Watchdog:
    """Evaluates the rule set against one registry. ``check()`` is
    called from a single timer thread; state (edge triggers, SLO
    trackers) is unlocked single-consumer."""

    def __init__(self, registry: Optional[_registry.Registry] = None,
                 slos: Sequence[SLOConfig] = (),
                 config: Optional[WatchdogConfig] = None):
        self.registry = registry if registry is not None \
            else _registry.REGISTRY
        self.config = config or WatchdogConfig()
        self.trackers: Dict[str, SLOTracker] = {
            cfg.name: SLOTracker(cfg) for cfg in slos}
        self._firing: Dict[str, bool] = {}   # rule key -> edge state

    # ------------------------------------------------------------ rules
    def _edge(self, key: str, condition: bool) -> bool:
        """True exactly when ``condition`` newly holds (rising edge)."""
        was = self._firing.get(key, False)
        self._firing[key] = condition
        return condition and not was

    def _emit(self, events: List[dict], kind: str, severity: str,
              source: str, **detail) -> None:
        rec = self.registry.record_event(kind, severity=severity,
                                         source=source, **detail)
        self.registry.counter("watchdog.events_total").inc()
        if rec is not None:
            events.append(rec)

    def check(self) -> List[dict]:
        """Run every rule once; returns the events emitted by THIS
        check (they are already recorded/streamed)."""
        cfg = self.config
        reg = self.registry
        reg.counter("watchdog.checks_total").inc()
        events: List[dict] = []
        view = reg.windows(cfg.window_s)

        # Sustained queue depth: min over the window never dipped below
        # the limit — admission is outrunning service for a full window.
        g = (view.get("gauges") or {}).get("serve.queue_depth")
        sustained = (g is not None
                     and g.get("min", 0.0) >= cfg.queue_depth_limit)
        if self._edge("queue_depth", sustained):
            self._emit(events, "watchdog.queue_depth_sustained",
                       "warning", "watchdog",
                       window_s=cfg.window_s,
                       min_depth=g.get("min"), max_depth=g.get("max"),
                       limit=cfg.queue_depth_limit)

        # TTFT regression vs trailing baseline: compare the current
        # window's p99 against the older history with the current
        # window EXCLUDED, so the regression can't dilute its own
        # baseline.
        interval = view.get("interval_s") or 0.0
        skip = int(cfg.window_s / interval + 0.999) if interval > 0 else 0
        baseline = reg.windows(cfg.baseline_window_s, skip=skip)
        cur = (view.get("histograms") or {}).get("serve.ttft_s")
        base = (baseline.get("histograms") or {}).get("serve.ttft_s")
        regressed = False
        if (cur is not None and base is not None
                and cur.get("count", 0) >= cfg.min_samples
                and base.get("count", 0) >= cfg.min_samples
                and base.get("p99", 0.0) > 0.0):
            regressed = (cur["p99"]
                         >= cfg.ttft_regression_factor * base["p99"])
        if self._edge("ttft_regression", regressed):
            self._emit(events, "watchdog.ttft_regression", "critical",
                       "watchdog", window_s=cfg.window_s,
                       current_p99=cur.get("p99"),
                       baseline_p99=base.get("p99"),
                       factor=cfg.ttft_regression_factor)

        # Replica flap: restarts within one window (router registries
        # only — elsewhere the counter simply never appears).
        c = (view.get("counters") or {}).get(
            "router.replica_restarts_total")
        flapping = (c is not None
                    and c.get("delta", 0.0) >= cfg.flap_limit)
        if self._edge("replica_flap", flapping):
            self._emit(events, "watchdog.replica_flap", "critical",
                       "watchdog", window_s=cfg.window_s,
                       restarts=c.get("delta"), limit=cfg.flap_limit)

        # SLO evaluations + burn-rate alerts.
        burn_max = 0.0
        for tracker in self.trackers.values():
            scfg = tracker.cfg
            verdict = evaluate_slo(scfg, reg.windows(scfg.window_s))
            reg.counter("slo.evaluations_total").inc()
            if not verdict["no_data"]:
                tracker.observe(verdict["ok"])
                if not verdict["ok"]:
                    reg.counter("slo.violations_total").inc()
            burn = tracker.burn_rate()
            burn_max = max(burn_max, burn)
            self._emit(events, "slo.eval",
                       "info" if verdict["ok"] else "warning", "slo",
                       burn_rate=burn, compliance=tracker.compliance,
                       **verdict)
            if self._edge(f"burn:{scfg.name}",
                          tracker.total > 0 and burn >= cfg.burn_alert):
                self._emit(events, "watchdog.slo_burn", "critical",
                           "slo", slo=scfg.name, burn_rate=burn,
                           compliance=tracker.compliance,
                           objective=scfg.objective,
                           limit=cfg.burn_alert)
        if self.trackers:
            reg.gauge("slo.burn_rate_max").set(burn_max)
        return events

    def status(self) -> dict:
        return {"config": asdict(self.config),
                "slos": [t.status() for t in self.trackers.values()],
                "firing": sorted(k for k, v in self._firing.items()
                                 if v)}


class WatchdogThread:
    """Daemon timer driving ``Watchdog.check()`` every interval — the
    serve-side wiring (the serve CLI's ``--watchdog-interval``).
    ``stop()`` is idempotent and joins the thread."""

    def __init__(self, watchdog: Watchdog,
                 interval_s: Optional[float] = None):
        self.watchdog = watchdog
        self.interval_s = float(interval_s
                                if interval_s is not None
                                else watchdog.config.interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="nezha-watchdog", daemon=True)

    def start(self) -> "WatchdogThread":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.watchdog.check()
            except Exception:
                # A watchdog bug must never take the serving loop down;
                # the failed check is skipped and the next tick retries.
                self.watchdog.registry.counter(
                    "watchdog.check_errors_total").inc()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
