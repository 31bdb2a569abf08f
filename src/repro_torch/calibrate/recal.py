"""AutoRecalibrator: drift flag -> re-probe one route -> refit -> hot-swap.

The port's copy of the reference's ``repro/calibrate/recal.py``.

Closes the drift loop: the ``DriftSentinel`` *flags* a route whose
observed transfer timings have drifted past the calibrated prediction;
this module is the react leg. On a flag it

  1. re-probes *only* the drifted route — a ``CalibrationRunner`` with
     ``truth_system=`` pointed at the live (possibly degraded) fabric and
     ``run(routes=[...])`` narrowed to the one route, so recalibration
     costs a handful of probe transfers, not a full calibration pass;
  2. robust-refits that route's constants (``fit_route`` via
     ``fit_profile`` — same dispersion down-weighting and residual trim as
     the original calibration) against the *nominal* preset, producing an
     updated ``CalibrationProfile`` with the stale estimate replaced and
     the new samples appended to provenance;
  3. hot-swaps the fitted constants into the serving expectation:
     ``from_profile`` rebuilds the calibrated ``System``, the sentinel is
     rebased onto it and the route's flag acknowledged (``clear``), so
     post-swap observations are judged against the machine as it now is —
     drift ratio back to ~1.0 instead of serving on a stale model forever.

``recal.start`` / ``recal.done`` trace instants and ``recal.*`` metrics
make every swap auditable on the same tracer as the drift that caused it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.calibrate.profile import (CalibrationProfile,
                                           LinkEstimate)
from repro_torch.calibrate.runner import (DEFAULT_SIZES,
                                          CalibrationRunner)
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class RecalResult:
    """One completed recalibration of one route."""
    route: str                       # "src->dst" route key (sentinel's)
    tier: str                        # tier the route probes
    old_estimate: LinkEstimate
    estimate: LinkEstimate           # refit constants
    profile: CalibrationProfile      # updated profile (estimate swapped in)
    system: object                   # from_profile(profile) — the new expectation
    n_samples: int
    ts: Optional[float] = None

    def time_scale(self, nbytes: float) -> float:
        """new predicted / old predicted transfer time for ``nbytes`` on
        this route — the factor a scalar expectation anchored on the old
        constants (e.g. the degradation detector's expected fetch)
        rescales by after the swap."""
        old = nbytes / self.old_estimate.bandwidth \
            + self.old_estimate.latency
        new = nbytes / self.estimate.bandwidth + self.estimate.latency
        return new / old if old > 0 else 1.0

    def to_json(self) -> dict:
        return {
            "route": self.route,
            "tier": self.tier,
            "ts": self.ts,
            "n_samples": self.n_samples,
            "old_bandwidth": self.old_estimate.bandwidth,
            "old_latency": self.old_estimate.latency,
            "fitted_bandwidth": self.estimate.bandwidth,
            "fitted_latency": self.estimate.latency,
            "efficiency": self.estimate.efficiency,
            "rel_residual": self.estimate.rel_residual,
        }


class AutoRecalibrator:
    """Re-probe a flagged route against the live fabric and hot-swap the
    refit constants into the calibration profile / drift sentinel.

    ``profile`` is the serving ``CalibrationProfile``; ``sentinel`` (a
    ``DriftSentinel``, optional) is rebased onto the updated system and
    the route's flag cleared after each swap. The probe ladder defaults to
    a cheaper subset of the full calibration's (recalibration runs inside
    a serving loop; two repeats of the standard sizes recover the route's
    two constants to ~1%). ``self.profile`` always holds the latest
    swapped profile, ``self.recals`` the history.
    """

    def __init__(self, profile: CalibrationProfile, *,
                 preset: Optional[str] = None, sentinel=None,
                 tracer=NULL_TRACER, sizes=DEFAULT_SIZES,
                 repeats: int = 2, iters: int = 5, noise: float = 0.01,
                 seed: int = 1):
        self.profile = profile
        self.preset = preset or profile.system
        self.sentinel = sentinel
        self.tracer = tracer
        self.sizes = tuple(sizes)
        self.repeats = int(repeats)
        self.iters = int(iters)
        self.noise = float(noise)
        self.seed = int(seed)
        self.recals: list = []

    def _route_tier(self, route_key: str) -> tuple:
        """Resolve a sentinel route key ``"src->dst"`` to the probe route
        ``(tier, src, dst)`` the runner vocabulary uses."""
        if "->" not in route_key:
            raise ValueError(f"route key {route_key!r} is not 'src->dst'")
        src, dst = route_key.split("->", 1)
        from repro_torch.fabric.systems import get_system
        nominal = get_system(self.preset)
        for tier, node in sorted(nominal.tier_map.items()):
            if node == src and node != nominal.compute:
                return tier, src, dst
        raise ValueError(
            f"route {route_key!r} does not start at a mapped memory tier "
            f"of {self.preset} (have {sorted(nominal.tier_map.items())}); "
            "only probed tier->compute routes can be recalibrated")

    def recalibrate(self, route_key: str, *, truth_system,
                    ts: Optional[float] = None) -> RecalResult:
        """Re-probe ``route_key`` on ``truth_system`` (the fabric as it is
        *now* — in simulation, the degraded ``System`` the serve loop
        plans on), refit, swap, acknowledge. Returns the ``RecalResult``;
        ``self.profile`` is updated in place for the next flag."""
        from repro_torch.calibrate.fit import fit_profile
        from repro_torch.fabric.systems import from_profile

        tier, src, dst = self._route_tier(route_key)
        old = self.profile.estimate(src, dst)
        tracer = self.tracer
        if tracer.enabled:
            tracer.instant("recal.start", ts=ts, track=("recal", "routes"),
                           cat="recal", route=route_key, tier=tier,
                           old_bandwidth=old.bandwidth)

        from repro_torch.calibrate.runner import TruthConfig
        runner = CalibrationRunner(
            self.preset, source="emulated",
            truth=TruthConfig(noise=self.noise,
                              seed=self.seed + len(self.recals)),
            truth_system=truth_system, sizes=self.sizes,
            repeats=self.repeats, iters=self.iters)
        samples = runner.run(routes=[(tier, src, dst)])
        # fit_profile against the nominal preset: the refit efficiency /
        # latency_ratio are expressed against the same reference the rest
        # of the profile uses, so from_profile rescales consistently
        mini = fit_profile(samples, runner.system,
                           machine=dict(self.profile.machine))
        est = mini.estimate(src, dst)

        links = tuple(est if (e.src, e.dst) == (src, dst) else e
                      for e in self.profile.links)
        updated = dataclasses.replace(
            self.profile, links=links,
            samples=tuple(self.profile.samples) + tuple(samples))
        system = from_profile(updated, preset=self.preset)
        self.profile = updated

        if self.sentinel is not None:
            self.sentinel.rebase(system)
            self.sentinel.clear(route_key)
        if tracer.enabled:
            tracer.instant("recal.done", ts=ts, track=("recal", "routes"),
                           cat="recal", route=route_key,
                           fitted_bandwidth=est.bandwidth,
                           fitted_latency=est.latency,
                           efficiency=est.efficiency,
                           n_samples=len(samples))
            m = tracer.metrics
            m.add("recal.count", 1, route=route_key)
            m.add("recal.samples", len(samples), route=route_key)
            m.set("recal.bandwidth", est.bandwidth, route=route_key)
            m.set("recal.latency", est.latency, route=route_key)
        result = RecalResult(
            route=route_key, tier=tier, old_estimate=old, estimate=est,
            profile=updated, system=system, n_samples=len(samples), ts=ts)
        self.recals.append(result)
        return result
