"""Drift sentinel: observed transfer timings vs calibration predictions.

The port's copy of the reference's ``repro/obs/drift.py``: the
expectation is a ``System`` or a ``CalibrationProfile`` (built into one by
``fabric.systems.from_profile``).

Closes the Cohet-style loop the ROADMAP calls for: a ``CalibrationProfile``
is a statement about the machine at fit time, and the machine drifts —
links degrade, co-tenants appear, firmware changes arbitration. The
sentinel replays each observed per-route transfer plan against what the
*calibrated* model predicts for the same bytes under the same declared
background and QoS class, and flags routes whose observed/predicted ratio
sustains past a threshold. Because the prediction conditions on the
declared contention, a flagged route means the *physical* link changed —
not that someone else was merely using it.

Feed it from any ``repro_torch.transport`` plan (``observe_plan``): the
degradation serve loop passes each round's prefetch plan, so per-link
drift shows up on the same tracer (``drift.ratio`` counters, ``drift.flag``
instants) and in ``report()`` — which names the degraded route and clears
the healthy ones, the headline check ``heimdall.obs`` enforces.
"""

from __future__ import annotations

import collections
import statistics
from typing import Callable, Optional

from repro_torch.obs.trace import NULL_TRACER


def _expected_system(expected, preset: Optional[str]):
    """Resolve the expectation to a System: pass a System through, build
    one from a ``CalibrationProfile`` (lazy import — obs stays base)."""
    if hasattr(expected, "links") and hasattr(expected, "estimate"):
        from repro_torch.fabric.systems import from_profile
        return from_profile(expected, preset=preset)
    return expected


class _RouteState:
    def __init__(self, window: int):
        self.ratios: collections.deque = collections.deque(maxlen=window)
        self.n_obs = 0
        self.flagged = False         # sticky: has it ever crossed
        self.last_predicted = 0.0
        self.last_observed = 0.0


class DriftSentinel:
    """Per-route drift detector anchored on a calibrated expectation.

    ``expected`` is a ``fabric.System`` (e.g. ``from_profile(...)``)
    or a ``CalibrationProfile`` directly. A route is *drifting* while the
    median observed/predicted ratio over the last ``window`` observations
    exceeds ``threshold`` (with at least ``min_obs`` observations);
    ``flagged`` is the sticky has-ever-drifted bit the report carries.
    """

    def __init__(self, expected, *, preset: Optional[str] = None,
                 threshold: float = 1.3, min_obs: int = 3,
                 window: int = 16, tracer=NULL_TRACER,
                 on_flag: Optional[Callable] = None):
        self.expected = _expected_system(expected, preset)
        self.threshold = float(threshold)
        self.min_obs = int(min_obs)
        self.window = int(window)
        self.tracer = tracer
        self.on_flag = on_flag
        self._routes: dict[str, _RouteState] = {}

    def predict(self, route, wire_bytes: float, *, background=(),
                weight=None, priority=None) -> Optional[float]:
        """Calibrated-model time for ``wire_bytes`` on the expectation's
        version of ``route`` (None when the route does not resolve
        there — e.g. a node the expectation never knew)."""
        from repro_torch.transport import Route
        exp_route = Route.try_resolve(self.expected, route.src, route.dst)
        if exp_route is None:
            return None
        kw = {}
        if weight is not None:
            kw["weight"] = weight
        if priority is not None:
            kw["priority"] = priority
        return exp_route.contended_transfer_time(wire_bytes, background,
                                                 **kw)

    def observe_plan(self, plan, *, background=(),
                     observed_s: Optional[float] = None,
                     ts: Optional[float] = None) -> Optional[float]:
        """Feed one executed ``TransferPlan``; returns the ratio (or None
        when no prediction is possible).

        ``observed_s`` defaults to ``plan.total_time`` — correct for plans
        whose transfers start at t=0 (the pager's); pass the measured
        duration explicitly otherwise. ``background`` must be the *same*
        declared contention the plan ran under, so the ratio isolates
        physical change from known sharing.
        """
        transfers = getattr(plan, "transfers", ())
        if not transfers:
            return None
        tr0 = transfers[0]
        predicted = self.predict(plan.route, plan.wire_bytes,
                                 background=background,
                                 weight=tr0.weight, priority=tr0.priority)
        if predicted is None or predicted <= 0:
            return None
        observed = plan.total_time if observed_s is None else observed_s
        ratio = observed / predicted
        key = plan.route.label
        st = self._routes.get(key)
        if st is None:
            st = self._routes[key] = _RouteState(self.window)
        st.ratios.append(ratio)
        st.n_obs += 1
        st.last_predicted = predicted
        st.last_observed = observed
        drifting = self._drifting(st)
        tracer = self.tracer
        if tracer.enabled:
            tracer.counter("drift.ratio", {key: ratio}, ts=ts,
                           track=("drift", "routes"), cat="drift")
        if drifting and not st.flagged:
            st.flagged = True
            if tracer.enabled:
                tracer.instant("drift.flag", ts=ts,
                               track=("drift", "routes"), cat="drift",
                               route=key,
                               median_ratio=statistics.median(st.ratios),
                               observed_s=observed, predicted_s=predicted)
                tracer.metrics.add("drift.flags", 1, route=key)
            if self.on_flag is not None:
                # rising-edge only (parity with SLOMonitor.on_alert):
                # fires once per flag transition, never per observation
                self.on_flag(key, {
                    "median_ratio": statistics.median(st.ratios),
                    "observed_s": observed, "predicted_s": predicted,
                    "ts": ts,
                })
        return ratio

    def clear(self, route: str) -> bool:
        """Acknowledge a flag: reset the route's sticky bit *and* ratio
        window, so post-recalibration observations start a fresh median
        (stale pre-swap ratios would otherwise keep the route "drifting"
        for up to ``window`` observations). Returns whether the route was
        known. The next sustained excursion re-flags and re-fires
        ``on_flag`` — acknowledgment is per-episode, not permanent."""
        st = self._routes.get(route)
        if st is None:
            return False
        was = st.flagged
        st.flagged = False
        st.ratios.clear()
        if self.tracer.enabled and was:
            self.tracer.instant("drift.clear", track=("drift", "routes"),
                                cat="drift", route=route)
        return True

    def rebase(self, expected, *, preset: Optional[str] = None) -> None:
        """Hot-swap the calibrated expectation (e.g. after an
        ``AutoRecalibrator`` refit) without losing per-route history."""
        self.expected = _expected_system(expected, preset)

    def _drifting(self, st: _RouteState) -> bool:
        return (len(st.ratios) >= self.min_obs
                and statistics.median(st.ratios) > self.threshold)

    def drifting_routes(self) -> list:
        """Routes currently over threshold (median of the live window)."""
        return sorted(k for k, st in self._routes.items()
                      if self._drifting(st))

    def flagged_routes(self) -> list:
        """Routes that have ever crossed (the sticky bit)."""
        return sorted(k for k, st in self._routes.items() if st.flagged)

    def report(self) -> dict:
        """Per-route drift state for reports and the CI artifact."""
        routes = {}
        for key, st in sorted(self._routes.items()):
            routes[key] = {
                "n_obs": st.n_obs,
                "median_ratio": (statistics.median(st.ratios)
                                 if st.ratios else None),
                "last_ratio": st.ratios[-1] if st.ratios else None,
                "last_observed_s": st.last_observed,
                "last_predicted_s": st.last_predicted,
                "drifting": self._drifting(st),
                "flagged": st.flagged,
            }
        return {"threshold": self.threshold, "min_obs": self.min_obs,
                "window": self.window, "routes": routes,
                "flagged": self.flagged_routes()}
