"""SLO layer: per-lane latency windows with declared budgets and
error-budget burn tracking.

The counterpart of the JAX package's ``obs/slo.py``, unchanged in
behaviour.  A *budget* declares "lane X's p99 stays under T ms, with at
most ``allowed_frac`` of observations over T".  Four lanes are fed:
whole-cycle latency (``cycle``), the device lane (``device``), the
idle-skip floor (``idle``: cycles that dispatched no solve must stay near
the null-delta cost) and the pod time-to-bind (``ttb``, fed by the journey
log, ``obs/journey.py``, one observation per first bind through
``observe_sample`` / ``observe_samples``).

Tracking is a fixed sliding window (a deque of the last ``window``
observations per lane): bounded memory, exact percentiles over the
window.  The *burn rate* is (violations / the CONFIGURED window size) /
allowed_frac; a burn rate >= 1.0 means the lane consumes its error budget
faster than the SLO allows.  The denominator is the configured window, not
the filled part: while the window fills, each violation is worth 1/window
of budget, so a few clustered early spikes (a first compile, a cold cache)
do not read as a breach.  ``observe`` reports breach EDGES (enter-breach
transitions, re-armed when the window drops back under), so a sustained
breach costs one anomaly, not one per cycle; the auditor
(``obs/audit.py``) turns those into ``slo-budget-exceeded`` anomalies.

Budgets come from the environment (``VOLCANO_TPU_SLO_CYCLE_P99_MS``,
``VOLCANO_TPU_SLO_DEVICE_P99_MS``, ``VOLCANO_TPU_SLO_IDLE_P99_MS``,
``VOLCANO_TPU_SLO_TTB_P99_MS``; unset = tracked but unbudgeted) or from
``declare``.

Stdlib-only; internally synchronized (one small lock), so a reader never
holds the cycle thread for more than a dict copy.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List

DEFAULT_WINDOW = 256
# Minimum observations before a burn-rate breach can fire: percentile
# math over a handful of warm-up cycles is noise, not signal.
MIN_SAMPLES = 16
DEFAULT_ALLOWED_FRAC = 0.01

_ENV_BUDGETS = (
    ("cycle", "VOLCANO_TPU_SLO_CYCLE_P99_MS"),
    ("device", "VOLCANO_TPU_SLO_DEVICE_P99_MS"),
    ("idle", "VOLCANO_TPU_SLO_IDLE_P99_MS"),
    # Pod time-to-bind (obs/journey.py): one observation per FIRST bind,
    # fed through observe_sample.
    ("ttb", "VOLCANO_TPU_SLO_TTB_P99_MS"),
)


class Budget:
    __slots__ = ("lane", "target_ms", "allowed_frac")

    def __init__(self, lane: str, target_ms: float,
                 allowed_frac: float = DEFAULT_ALLOWED_FRAC):
        self.lane = lane
        self.target_ms = float(target_ms)
        self.allowed_frac = max(float(allowed_frac), 1e-6)


def _pct(vals: List[float], q: float) -> float:
    vals = sorted(vals)
    i = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
    return vals[i]


class SLOTracker:
    """Per-lane sliding-window latency tracker with budget burn."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = max(int(window), MIN_SAMPLES)
        self._lock = threading.Lock()
        self._lanes: Dict[str, deque] = {}  # guarded-by: _lock
        self.budgets: Dict[str, Budget] = {}  # guarded-by: _lock
        self._breached: Dict[str, bool] = {}  # guarded-by: _lock
        # Monotone per-lane violation counters (the burn counters; the
        # instantaneous burn rate is in snapshot()).
        self.violations: Dict[str, int] = {}  # guarded-by: _lock
        self.observations: Dict[str, int] = {}  # guarded-by: _lock
        for lane, env in _ENV_BUDGETS:
            raw = os.environ.get(env)
            if raw:
                try:
                    self.budgets[lane] = Budget(lane, float(raw))
                except ValueError:
                    pass

    def declare(self, lane: str, target_ms: float,
                allowed_frac: float = DEFAULT_ALLOWED_FRAC) -> None:
        with self._lock:
            self.budgets[lane] = Budget(lane, target_ms, allowed_frac)
            self._breached.pop(lane, None)

    # ------------------------------------------------------------ observe

    def observe(self, duration_s: float, lanes: Dict[str, float],
                idle: bool = False) -> List[dict]:
        """Feed one cycle; returns breach-edge dicts (possibly empty).
        ``lanes`` is the cycle's lane-seconds dict; ``idle`` marks a
        cycle that dispatched no solve (the idle-skip floor lane)."""
        obs = {"cycle": duration_s * 1e3}
        dev = lanes.get("device")
        if dev is not None:
            obs["device"] = dev * 1e3
        if idle:
            obs["idle"] = duration_s * 1e3
        breaches: List[dict] = []
        with self._lock:
            for lane, ms in obs.items():
                self._feed_locked(lane, ms, breaches)
        return breaches

    def observe_sample(self, lane: str, ms: float) -> List[dict]:
        """Feed one out-of-cycle observation (the journey's per-pod
        time-to-bind) into ``lane`` with the same budget, burn-rate and
        breach-edge semantics as ``observe``."""
        breaches: List[dict] = []
        with self._lock:
            self._feed_locked(lane, float(ms), breaches)
        return breaches

    def observe_samples(self, lane: str, values: List[float]
                        ) -> List[dict]:
        """``observe_sample`` of every float of ``values`` in order, with
        one lock acquisition; a lane without a budget only fills its
        window."""
        breaches: List[dict] = []
        with self._lock:
            if lane not in self.budgets:
                win = self._lanes.get(lane)
                if win is None:
                    win = self._lanes[lane] = deque(maxlen=self.window)
                win.extend(values)
                self.observations[lane] = (
                    self.observations.get(lane, 0) + len(values))
                return breaches
            for v in values:
                self._feed_locked(lane, float(v), breaches)
        return breaches

    # holds: _lock
    def _feed_locked(self, lane: str, ms: float,
                     breaches: List[dict]) -> None:
        from ..metrics import metrics

        win = self._lanes.get(lane)
        if win is None:
            win = self._lanes[lane] = deque(maxlen=self.window)
        win.append(ms)
        self.observations[lane] = self.observations.get(lane, 0) + 1
        b = self.budgets.get(lane)
        if b is None:
            return
        if ms > b.target_ms:
            self.violations[lane] = self.violations.get(lane, 0) + 1
        if len(win) < MIN_SAMPLES:
            return
        over = sum(1 for v in win if v > b.target_ms)
        # Burn over the CONFIGURED window (unfilled slots count healthy).
        burn = (over / self.window) / b.allowed_frac
        was = self._breached.get(lane, False)
        now = burn >= 1.0
        self._breached[lane] = now
        metrics.slo_burn_rate.set(round(burn, 4), lane=lane)
        if now and not was:
            breaches.append({
                "lane": lane,
                "target_ms": b.target_ms,
                "observed_ms": round(ms, 3),
                "window_p99_ms": round(_pct(list(win), 0.99), 3),
                "burn_rate": round(burn, 2),
                "over_in_window": over,
                "window": len(win),
            })

    # ------------------------------------------------------------- reads

    def snapshot(self) -> dict:
        """Per-lane p50/p99 over the window, declared budgets, burn
        rates, breach state (the ``health()`` "slo" section)."""
        with self._lock:
            lanes = {k: list(v) for k, v in self._lanes.items()}
            budgets = dict(self.budgets)
            breached = dict(self._breached)
            violations = dict(self.violations)
            observations = dict(self.observations)
        out = {}
        for lane, vals in sorted(lanes.items()):
            b = budgets.get(lane)
            entry = {
                "window": len(vals),
                "p50_ms": round(_pct(vals, 0.50), 3) if vals else None,
                "p99_ms": round(_pct(vals, 0.99), 3) if vals else None,
                "observations": observations.get(lane, 0),
            }
            if b is not None:
                over = sum(1 for v in vals if v > b.target_ms)
                burn = ((over / self.window) / b.allowed_frac
                        if vals else 0.0)
                entry.update({
                    "target_p99_ms": b.target_ms,
                    "allowed_frac": b.allowed_frac,
                    "violations_total": violations.get(lane, 0),
                    "burn_rate": round(burn, 4),
                    "breached": breached.get(lane, False),
                    "budget_remaining": round(max(1.0 - burn, 0.0), 4),
                })
            out[lane] = entry
        return out
