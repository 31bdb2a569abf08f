"""Step-time straggler detection.

The port's copy of ``StragglerStats`` from the reference's
``repro/runtime/fault.py``; the step supervisor and retry loop there come
with the training slice.
"""

from __future__ import annotations

import statistics


class StragglerStats:
    """Flags sustained step-time inflation (p95/median ratio).

    The detection signal of both the training fault loop and the serving
    degradation loop: a healthy window has p95 close to its median; a
    degraded link or sick host stretches the tail first. ``min_samples``
    guards against firing on a near-empty window.
    """

    def __init__(self, window: int = 50, ratio: float = 1.5,
                 min_samples: int = 10):
        self.window = window
        self.ratio = ratio
        self.min_samples = max(2, min_samples)
        self.times: list[float] = []

    def record(self, dt: float):
        self.times.append(dt)
        self.times = self.times[-self.window:]

    def _stats(self) -> tuple:
        s = sorted(self.times)
        # statistics.median averages the middle pair on even-length
        # windows; s[len//2] would pick the upper element, which on a
        # bimodal window inflates the denominator and masks real tails
        return (statistics.median(s), s[min(len(s) - 1,
                                            int(len(s) * 0.95))])

    @property
    def inflated(self) -> bool:
        if len(self.times) < self.min_samples:
            return False
        med, p95 = self._stats()
        return p95 > self.ratio * med

    def summary(self) -> dict:
        if not self.times:
            return {}
        med, p95 = self._stats()
        return {"median_s": med, "p95_s": p95, "n": len(self.times),
                "inflated": self.inflated}
