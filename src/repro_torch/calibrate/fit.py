"""Robust measurement->constant fitting for link calibration.

The port's copy of the reference's ``repro/calibrate/fit.py``.

Each measured route contributes samples ``(nbytes, seconds)`` at several
transfer sizes; the link model is affine in the transfer size::

    seconds ~= nbytes / bandwidth + latency

so a weighted least-squares line through the samples yields both constants
at once (slope -> 1/bandwidth, intercept -> latency). Robustness comes from
two guards layered on top of plain least squares:

  1. **Dispersion down-weighting** (the ``time_fn`` noise guard): a sample
     whose repetitions scattered (IQR/median above ``max_dispersion``)
     carries little information and enters the fit at a fraction of the
     weight — noisy timings bend the line less instead of silently
     poisoning it.
  2. **Residual trimming** (one IRLS-style pass): after the first fit,
     samples whose relative residual exceeds ``trim_k`` times the median
     absolute residual are dropped and the line refit — a single wild
     measurement (page fault, compilation hiccup) cannot drag the slope.

Degenerate inputs (non-positive slope from pure noise) fall back to a
percentile estimator: bandwidth from the largest-size samples' byte rate,
latency from the smallest-size residual, clamped non-negative.
"""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

from repro_torch.calibrate.profile import (CalibrationProfile,
                                           LinkEstimate, LinkSample,
                                           machine_metadata)

DEFAULT_MAX_DISPERSION = 0.10    # IQR/median above this = unstable sample
_TRIM_K = 4.0                    # residual trim threshold (x median |resid|)


def sample_weight(dispersion: float,
                  max_dispersion: float = DEFAULT_MAX_DISPERSION) -> float:
    """Fit weight of one sample from its timing dispersion: 1 for a clean
    measurement, rolling off quadratically once IQR/median passes the
    stability threshold (an unstable sample is down-weighted, never
    trusted outright)."""
    if not math.isfinite(dispersion) or dispersion < 0:
        return 0.0
    return 1.0 / (1.0 + (dispersion / max_dispersion) ** 2)


def _wls_line(xs: Sequence[float], ys: Sequence[float],
              ws: Sequence[float]) -> tuple:
    """Weighted least-squares fit y = a + b*x -> (a, b)."""
    W = sum(ws)
    if W <= 0:
        raise ValueError("all samples carry zero weight; nothing to fit")
    mx = sum(w * x for w, x in zip(ws, xs)) / W
    my = sum(w * y for w, y in zip(ws, ys)) / W
    sxx = sum(w * (x - mx) ** 2 for w, x in zip(ws, xs))
    sxy = sum(w * (x - mx) * (y - my) for w, x, y in zip(ws, xs, ys))
    if sxx <= 0:
        return my, 0.0           # one size only: no slope information
    b = sxy / sxx
    return my - b * mx, b


def fit_route(samples: Sequence[LinkSample], *,
              nominal_bandwidth: float, nominal_latency: float,
              max_dispersion: float = DEFAULT_MAX_DISPERSION
              ) -> LinkEstimate:
    """Fit one route's ``LinkEstimate`` from its samples.

    ``nominal_bandwidth``/``nominal_latency`` are the preset route's
    constants (bottleneck bandwidth, summed hop latency) — the reference
    the fitted ``efficiency``/``latency_ratio`` are expressed against.
    """
    if not samples:
        raise ValueError("fit_route needs at least one sample")
    src, dst = samples[0].src, samples[0].dst
    for s in samples:
        if (s.src, s.dst) != (src, dst):
            raise ValueError(f"mixed routes in fit_route: {src}->{dst} vs "
                             f"{s.src}->{s.dst}")
    xs = [float(s.nbytes) for s in samples]
    ys = [s.seconds for s in samples]
    # Relative-space weights: timing noise is multiplicative (a 2% wobble
    # on a 10 ms transfer is a huge absolute error next to a 5 us probe),
    # so weight by 1/y^2 — otherwise the bulk sizes drown the small-size
    # samples that carry all the latency (intercept) information.
    ws = [sample_weight(s.dispersion, max_dispersion) / max(y, 1e-18) ** 2
          for s, y in zip(samples, ys)]
    n_down = sum(1 for s in samples if s.dispersion > max_dispersion)
    if all(w <= 0 for w in ws):          # every sample unstable: use them
        ws = [1.0 / max(y, 1e-18) ** 2 for y in ys]  # anyway vs fit nothing
    a, b = _wls_line(xs, ys, ws)

    # One residual-trim pass: drop wild points (relative residual beyond
    # _TRIM_K x the median), refit. Keeps at least half the samples; only
    # fires when the median residual is itself meaningful — on a
    # near-perfect fit, float-rounding scatter must not get "trimmed".
    keep = list(range(len(samples)))
    if len(samples) >= 4:
        resid = [abs(y - (a + b * x)) / max(y, 1e-18)
                 for x, y in zip(xs, ys)]
        med = statistics.median(resid)
        if med > 1e-9:
            cand = [i for i, r in enumerate(resid) if r <= _TRIM_K * med]
            if len(samples) // 2 <= len(cand) < len(samples):
                n_down += len(samples) - len(cand)
                keep = cand
                a, b = _wls_line([xs[i] for i in keep],
                                 [ys[i] for i in keep],
                                 [ws[i] for i in keep])
    kx = [xs[i] for i in keep]
    ky = [ys[i] for i in keep]
    kw = [ws[i] for i in keep]

    if b > 0:
        bandwidth, latency = 1.0 / b, max(a, 0.0)
    else:
        # Pure-noise degenerate fit: percentile fallback. Bandwidth from
        # the largest-size samples (latency is negligible there), latency
        # from the smallest-size samples' leftover time.
        big = max(kx)
        bandwidth = statistics.median(
            x / y for x, y in zip(kx, ky) if x == big and y > 0)
        small = min(kx)
        latency = max(0.0, statistics.median(
            y - x / bandwidth for x, y in zip(kx, ky) if x == small))

    # Weighted relative RMS residual over the samples the line was
    # actually fitted on — an outlier the trim pass excluded must not
    # inflate the fit-quality number CI thresholds.
    resid2 = sum(w * ((y - (x / bandwidth + latency)) / max(y, 1e-18)) ** 2
                 for w, x, y in zip(kw, kx, ky))
    rel_residual = math.sqrt(resid2 / max(sum(kw), 1e-18))

    return LinkEstimate(
        src=src, dst=dst, link_type=samples[0].link_type,
        bandwidth=bandwidth, latency=latency,
        efficiency=bandwidth / nominal_bandwidth,
        latency_ratio=(latency / nominal_latency if nominal_latency > 0
                       else 1.0),
        n_samples=len(samples), n_downweighted=n_down,
        rel_residual=rel_residual)


def fit_profile(samples: Sequence[LinkSample], system=None, *,
                max_dispersion: float = DEFAULT_MAX_DISPERSION,
                machine: Optional[dict] = None) -> CalibrationProfile:
    """Group samples by route, fit each, assemble the versioned profile.

    ``system`` is the *nominal* preset the efficiencies are expressed
    against (defaults to the preset named by the samples).
    """
    if not samples:
        raise ValueError("fit_profile needs at least one sample")
    from repro_torch.fabric.systems import get_system
    names = {s.system for s in samples}
    if len(names) > 1:
        raise ValueError(f"samples span multiple systems {sorted(names)}; "
                         "calibrate one machine per profile")
    system = system or get_system(samples[0].system)
    by_route: dict = {}
    for s in samples:
        by_route.setdefault((s.src, s.dst), []).append(s)
    estimates = []
    for (src, dst), group in sorted(by_route.items()):
        estimates.append(fit_route(
            group,
            nominal_bandwidth=system.fabric.route_bandwidth(src, dst),
            nominal_latency=system.fabric.route_latency(src, dst),
            max_dispersion=max_dispersion))
    sources = {s.source for s in samples}
    return CalibrationProfile(
        system=samples[0].system, links=tuple(estimates),
        samples=tuple(samples),
        source=sources.pop() if len(sources) == 1 else "mixed",
        machine=machine if machine is not None else machine_metadata())
