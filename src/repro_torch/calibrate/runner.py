"""CalibrationRunner: collect per-route transfer samples for the fitter.

The port of the reference's ``repro/calibrate/runner.py``. The paper's loop
is measure-then-explain: HEIMDALL probes each machine and the architectural
model must reproduce the measurements. This runner is the "measure" half,
with two sample sources:

  * ``"torch"``    — real transfers on the card: a read-direction bulk copy
                     of the probe's bytes from the tier into a fresh device
                     buffer (``hbm``: device to device; ``host``: pinned
                     host to device), timed with CUDA events around the copy
                     alone, so the fit's intercept is the link's latency and
                     not Python's dispatch. Only the addressable hbm/host
                     pair; on ``device="cpu"`` the same copies run in host
                     memory, timed with the host clock.
  * ``"emulated"`` — a deterministic *ground-truth machine*: the nominal
                     preset with hidden per-link-type efficiency factors
                     and a latency scale applied (``TruthConfig``), plus
                     multiplicative log-normal timing noise. This is the
                     Cohet-style setting in which calibration can be held
                     accountable: the truth constants exist, the fitter
                     must recover them, and ``validate`` replays scenarios
                     against the same truth machine. Its samples equal the
                     reference's bit for bit (the same ``random.Random``
                     draws in the same order).
  * ``"auto"``     — torch where a tier is addressable, emulated elsewhere.

Each route (memory node -> reference compute, the read direction) is probed
at a geometric ladder of transfer sizes; every sample carries the timing
dispersion (IQR/median). Samples whose dispersion exceeds the stability
threshold are re-measured up to ``max_reruns`` times (keeping the most
stable run) — the noise guard's first line; the fitter's down-weighting is
the second.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Sequence

import torch

from repro_torch.calibrate.profile import LinkSample

KiB = 1 << 10
MiB = 1 << 20

# Geometric ladder from latency-dominated probes (the small sizes are what
# make the fit's intercept identifiable) to bandwidth-dominated bulk.
DEFAULT_SIZES = (16 * KiB, 256 * KiB, 4 * MiB, 64 * MiB)


@dataclasses.dataclass(frozen=True)
class TruthConfig:
    """Hidden constants of the emulated ground-truth machine.

    ``efficiency`` maps link-type value (e.g. ``"pcie"``) to the fraction
    of nominal bandwidth the "hardware" actually delivers;
    ``default_efficiency`` covers unlisted types. ``latency_scale``
    multiplies every link latency (real links are slower than datasheet).
    ``noise`` is the relative sigma of the multiplicative log-normal
    timing noise; ``seed`` makes the whole machine deterministic.
    """
    efficiency: dict = dataclasses.field(default_factory=dict)
    default_efficiency: float = 0.85
    latency_scale: float = 1.25
    noise: float = 0.02
    seed: int = 0

    def link_efficiency(self, link_type: str) -> float:
        return float(self.efficiency.get(link_type,
                                         self.default_efficiency))


def ground_truth_system(name: str,
                        truth: Optional[TruthConfig] = None):
    """The emulated machine: the nominal preset with the truth's hidden
    per-link-type efficiencies and latency scale applied. ``validate``
    replays scenarios on this fabric to produce "measured" numbers."""
    from repro_torch.fabric.systems import get_system
    truth = truth or TruthConfig()
    base = get_system(name)
    scales = {}
    seen = set()
    for (a, b), link in base.fabric.links.items():
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        scales[key] = (truth.link_efficiency(link.type.value),
                       truth.latency_scale)
    fab = base.fabric.rescaled(scales, name=f"{base.name}+truth")
    return dataclasses.replace(base, fabric=fab,
                               description=f"{base.description} "
                                           f"(ground truth)")


class CalibrationRunner:
    """Probe one preset's routes and emit ``LinkSample``s for the fitter."""

    def __init__(self, system_name: str = "tpu_v5e", *,
                 source: str = "emulated",
                 truth: Optional[TruthConfig] = None,
                 truth_system=None,
                 sizes: Sequence[int] = DEFAULT_SIZES,
                 repeats: int = 3,
                 iters: int = 7,
                 max_dispersion: float = 0.10,
                 max_reruns: int = 2,
                 device=None):
        if source not in ("torch", "emulated", "auto"):
            raise ValueError(f"source must be torch|emulated|auto, "
                             f"got {source!r}")
        from repro_torch.fabric.systems import get_system
        self.system = get_system(system_name)
        self.source = source
        self.truth = truth or TruthConfig()
        # truth_system override: probe a caller-supplied live System
        # (e.g. the degraded serving fabric the AutoRecalibrator
        # re-measures) instead of the synthetic TruthConfig machine
        self.truth_system = (truth_system if truth_system is not None
                             else ground_truth_system(system_name,
                                                      self.truth))
        self.sizes = tuple(sizes)
        self.repeats = repeats            # samples per (route, size)
        self.iters = iters                # timing repetitions per sample
        self.max_dispersion = max_dispersion
        self.max_reruns = max_reruns
        self._rng = random.Random(self.truth.seed)
        # where the real probe copies to (default cuda), resolved when a
        # probe first runs: an emulated runner needs no device
        self.device = device

    # -- measurement backends ------------------------------------------------
    def _measure_emulated(self, src: str, dst: str, nbytes: int) -> tuple:
        """One emulated sample: the truth machine's closed-form transfer
        time under ``iters`` noisy repetitions -> (median, dispersion)."""
        fab = self.truth_system.fabric
        base = nbytes / fab.route_bandwidth(src, dst) \
            + fab.route_latency(src, dst)
        times = sorted(base * math.exp(self._rng.gauss(0.0, self.truth.noise))
                       for _ in range(self.iters))
        med = times[len(times) // 2]
        q1 = times[len(times) // 4]
        q3 = times[(3 * len(times)) // 4]
        return med, (q3 - q1) / med

    _TORCH_TIERS = ("hbm", "host")

    def _measure_torch(self, tier: str, nbytes: int) -> tuple:
        """One timed sample: a bulk copy of ``nbytes`` from ``tier`` into a
        fresh device buffer (the harness's read-direction probe). Every
        tier moves its bytes: ``hbm`` copies device to device (placing an
        HBM tensor on the device would return the tensor itself and time
        nothing), ``host`` copies pinned host memory to the device."""
        from repro_torch.heimdall.harness import copy_time_stats, place
        from repro_torch.models.context import resolve_device
        device = resolve_device(self.device)
        n = max(1, nbytes // 4)
        x = place(torch.arange(n, dtype=torch.float32), tier, device)
        t = copy_time_stats(x, device, warmup=2, iters=self.iters)
        return t.median, t.dispersion

    def _sample_once(self, tier: str, src: str, dst: str,
                     nbytes: int, real: bool) -> tuple:
        if real:
            return self._measure_torch(tier, nbytes)
        return self._measure_emulated(src, dst, nbytes)

    # -- collection ----------------------------------------------------------
    def routes(self) -> list:
        """(tier, src node, dst node) probe routes: every mapped tier read
        from the reference compute node."""
        out = []
        for tier, node in sorted(self.system.tier_map.items()):
            if node == self.system.compute:
                continue
            out.append((tier, node, self.system.compute))
        return out

    def run(self, routes: Optional[list] = None) -> list:
        """Collect samples (the fitter's input); ``routes`` narrows the
        probe to a subset of ``(tier, src, dst)`` routes — how the
        auto-recalibrator re-measures *only* the drifted route instead of
        re-running the full calibration pass.

        The noise guard lives here first: a sample whose dispersion exceeds
        ``max_dispersion`` is re-measured up to ``max_reruns`` times and
        the most stable run kept; whatever instability survives is recorded
        in the sample for the fitter to down-weight.
        """
        samples = []
        if routes is None:
            routes = self.routes()
        if self.source == "torch" and not any(t in self._TORCH_TIERS
                                              for t, _, _ in routes):
            raise ValueError(
                f"{self.system.name}: no tier the card addresses to measure "
                f"(have {[t for t, _, _ in routes]}); use source='emulated'")
        for tier, src, dst in routes:
            real = (self.source in ("torch", "auto")
                    and tier in self._TORCH_TIERS)
            route = self.system.fabric.route(src, dst)
            link_type = min(route, key=lambda l: l.bandwidth).type.value
            for nbytes in self.sizes:
                for _ in range(self.repeats):
                    sec, disp = self._sample_once(tier, src, dst, nbytes,
                                                  real)
                    reruns = 0
                    while disp > self.max_dispersion \
                            and reruns < self.max_reruns:
                        sec2, disp2 = self._sample_once(
                            tier, src, dst, nbytes, real)
                        reruns += 1
                        if disp2 < disp:          # keep the stabler run
                            sec, disp = sec2, disp2
                    samples.append(LinkSample(
                        system=self.system.name, src=src, dst=dst,
                        link_type=link_type, nbytes=nbytes, seconds=sec,
                        dispersion=disp,
                        source="torch" if real else "emulated",
                        reruns=reruns))
        return samples

    def calibrate(self, *, max_dispersion: Optional[float] = None):
        """measure -> fit in one call; returns the ``CalibrationProfile``."""
        from repro_torch.calibrate.fit import fit_profile
        return fit_profile(
            self.run(), self.system,
            max_dispersion=(self.max_dispersion if max_dispersion is None
                            else max_dispersion))
