"""Elastic serving under fabric degradation: inject, detect, recover.

The port of the reference's ``repro/runtime/degrade.py``. The loop plans on
the fabric simulator's presets, so every time in its reports is
*simulated*; the pager it drives is real, though: its pools live on the
run's ``device`` (``cuda`` unless the caller asks for the CPU), and the
recovery step (``retier``, then a re-spill) moves real pages across the
host link.

The paper's central warning is that coherent-link performance is not a
constant: host-link bandwidth collapses under co-running interference
(CXL-Interference's regime) and pooled tiers can be hot-removed mid-run
(the CXL survey's production event). This module closes the
sense->decide->act loop over the stack that can already *measure*
(calibration), *arbitrate* (fabric DMA QoS), and *observe*
(``repro_torch.obs``) the fabric:

  * **inject** — ``DegradationSchedule``: timed events (a link dropping to
    a fraction of its bandwidth, a tier hot-removed, a noisy co-tenant
    flow appearing) rewritten into the fabric graph via
    ``FabricTopology.rescaled`` / ``without_nodes``, so the simulator,
    cost model, and placement all plan on the degraded truth.
  * **detect** — ``DegradationDetector``: fetch-ETA drift against the
    expected (calibrated) plan plus ``StragglerStats`` tail inflation,
    emitted as ``resilience.*`` metrics and trace instants.
  * **recover** — ``RecoveryController``: re-derive the KV interleave on
    the degraded fabric (``elastic.replan_interleave``), migrate pages off
    the sick tier (``PagedKVCache.retier``), shed the batch-class offload
    stream and raise the prefetch DMA class so interactive deadlines
    survive (the existing QoS machinery doing the protecting).

``run_degraded_serve`` drives the whole loop round by round and reports
detection latency, recovery fraction, and SLO violations — the numbers
``heimdall/resilience.py`` benchmarks and CI enforces. Events are keyed by
serve *round* (the loop's own clock), which keeps detection-window
accounting deterministic under any step-time setting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.models.context import resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.elastic import replan_interleave
from repro_torch.runtime.fault import StragglerStats

# --------------------------------------------------------------------------
# Injection: a schedule of timed fabric-degradation events
# --------------------------------------------------------------------------

_KINDS = ("link_degrade", "tier_removed", "co_tenant")


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One timed fault. ``at_round`` is the serve round it fires at; a
    ``link_degrade``/``co_tenant`` with ``until_round`` set clears again
    at that round (half-open interval), otherwise it persists."""
    at_round: int
    kind: str
    link: Optional[tuple] = None         # (node_a, node_b), link_degrade
    factor: float = 1.0                  # surviving bandwidth fraction
    tier: Optional[str] = None           # tier name, tier_removed
    flow: Optional[object] = None        # fabric Flow, co_tenant
    until_round: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"have {_KINDS}")
        if self.kind == "link_degrade" and (
                self.link is None or not 0.0 < self.factor):
            raise ValueError("link_degrade needs link=(a, b) and a "
                             "factor > 0")
        if self.kind == "tier_removed" and self.tier is None:
            raise ValueError("tier_removed needs tier=")
        if self.kind == "co_tenant" and self.flow is None:
            raise ValueError("co_tenant needs flow=")

    def active_at(self, rnd: int) -> bool:
        if rnd < self.at_round:
            return False
        return self.until_round is None or rnd < self.until_round


def link_degrade(at_round: int, a: str, b: str, factor: float,
                 until_round: Optional[int] = None) -> DegradationEvent:
    """Link a<->b drops to ``factor`` of its bandwidth at ``at_round``."""
    return DegradationEvent(at_round, "link_degrade",
                            link=(min(a, b), max(a, b)), factor=factor,
                            until_round=until_round)


def tier_removed(at_round: int, tier: str) -> DegradationEvent:
    """Tier's memory node is hot-removed at ``at_round`` (permanent)."""
    return DegradationEvent(at_round, "tier_removed", tier=tier)


def co_tenant(at_round: int, flow,
              until_round: Optional[int] = None) -> DegradationEvent:
    """A noisy co-tenant ``Flow`` appears at ``at_round`` (tier- or
    node-named endpoints; open-ended nbytes=0 streams model steady
    interference)."""
    return DegradationEvent(at_round, "co_tenant", flow=flow,
                            until_round=until_round)


@dataclasses.dataclass(frozen=True)
class DegradationSchedule:
    """An ordered set of fault events applied to a base ``System``."""
    events: tuple

    @property
    def first_event_round(self) -> int:
        return min((e.at_round for e in self.events), default=0)

    def scales_at(self, rnd: int) -> dict:
        """Active multiplicative link scales (stacking degradations on the
        same pair multiply), in ``FabricTopology.rescaled`` key form."""
        scales: dict = {}
        for e in self.events:
            if e.kind == "link_degrade" and e.active_at(rnd):
                bw, lat = scales.get(e.link, (1.0, 1.0))
                scales[e.link] = (bw * e.factor, lat)
        return scales

    def removed_tiers_at(self, rnd: int) -> set:
        return {e.tier for e in self.events
                if e.kind == "tier_removed" and e.active_at(rnd)}

    def co_flows_at(self, rnd: int) -> tuple:
        return tuple(e.flow for e in self.events
                     if e.kind == "co_tenant" and e.active_at(rnd))

    def degraded_system(self, base, rnd: int):
        """The system as round ``rnd`` actually sees it.

        Link scales go through ``fabric.rescaled``, removed tiers through
        ``fabric.without_nodes`` (their ``tier_map`` entries dropped too,
        so stale tier names fail loudly). Removing the spill tier leaves a
        single-tier machine (``kv_tiers=None``); removing the *fast* tier
        is not survivable and raises.
        """
        scales = self.scales_at(rnd)
        removed = self.removed_tiers_at(rnd)
        if not scales and not removed:
            return base
        for key in scales:
            if key not in {(min(a, b), max(a, b))
                           for a, b in base.fabric.links}:
                raise ValueError(f"link_degrade names unknown link {key} "
                                 f"in {base.name}")
        fab = base.fabric
        if scales:
            fab = fab.rescaled(scales, name=f"{base.name}+degraded")
        kv = base.kv_tiers
        tier_map = dict(base.tier_map)
        if removed:
            nodes = []
            for tier in removed:
                if tier not in tier_map:
                    raise ValueError(f"tier_removed names unknown tier "
                                     f"{tier!r} in {base.name}; have "
                                     f"{sorted(tier_map)}")
                nodes.append(tier_map.pop(tier))
            fab = fab.without_nodes(nodes, name=f"{base.name}+degraded")
            if kv is not None:
                if kv[0] in removed:
                    raise ValueError(
                        f"fast tier {kv[0]!r} hot-removed: not survivable "
                        f"(the compute's own memory)")
                if kv[1] in removed:
                    kv = None
        return dataclasses.replace(base, fabric=fab, tier_map=tier_map,
                                   kv_tiers=kv)


def host_link_degraded(system: str = "tpu_v5e", at_round: int = 4,
                       factor: float = 0.5) -> DegradationSchedule:
    """The headline scenario: every link on the compute<->spill-tier route
    drops to ``factor`` of its bandwidth mid-serve (a host PCIe/CXL link
    halved by interference is the CXL-Interference regime)."""
    from repro_torch.fabric.systems import get_system

    base = get_system(system)
    if base.kv_tiers is None:
        raise ValueError(f"{system} has no spill tier to degrade")
    spill = base.tier_node(base.kv_tiers[1])
    events = []
    seen = set()
    for l in base.fabric.route(spill, base.compute):
        key = (min(l.src, l.dst), max(l.src, l.dst))
        if key not in seen:
            seen.add(key)
            events.append(link_degrade(at_round, *key, factor))
    return DegradationSchedule(tuple(events))


# --------------------------------------------------------------------------
# Detection: fetch-ETA drift + straggler tail inflation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    drift_threshold: float = 1.3     # fetch time / expected fetch time
    patience: int = 2                # consecutive drifting rounds to fire
    straggler_window: int = 50
    straggler_ratio: float = 1.5
    min_samples: int = 10


def calibration_baseline(system, nbytes: int, *, background: Sequence = (),
                         weight: float = 1.0, priority: int = 0):
    """A pluggable detector baseline anchored on a calibrated system.

    Returns a zero-arg callable yielding the expected spill->compute fetch
    time for ``nbytes`` on ``system`` (a ``repro_torch.fabric.System``, e.g.
    ``from_profile(...)``) under the declared ``background`` — the same
    contended estimate the drift sentinel predicts with, so the detector
    and the sentinel share one notion of "expected". The plan is resolved
    lazily on first call and cached (the detector polls it every round).
    """
    from repro_torch.transport import Route

    if system.kv_tiers is None:
        raise ValueError(f"{system.name} has no spill tier: no fetch "
                         "route to baseline")
    cache: list = []

    def _expected() -> float:
        if not cache:
            route = Route.resolve(system, system.kv_tiers[1],
                                  system.compute)
            cache.append(route.contended_transfer_time(
                nbytes, background, weight=weight, priority=priority))
        return cache[0]

    return _expected


class DegradationDetector:
    """Round-granular degradation detector.

    Two signals, matching the two ways a sick fabric shows itself first:
    the *planned* fetch time drifting past ``drift_threshold`` x the
    expected (calibration-anchored) value, and the *observed* per-step
    completion tail inflating (``StragglerStats``). The detector fires
    when drift is sustained for ``patience`` rounds, corroborated by the
    straggler flag or by an external witness (``observe(...,
    corroborated=True)`` — e.g. the SLO monitor alerting while the
    critical-path attribution blames a link) — and immediately on
    ``hard_fail`` (a tier that simply disappeared). Once fired it stays
    fired; clearing is the recovery loop's job, not the detector's.

    The expectation is pluggable: pass a scalar ``expected_fetch_s`` (the
    legacy anchor) or ``baseline=`` — any zero-arg callable returning the
    current expected fetch seconds (``calibration_baseline`` builds the
    calibrated one; the drift sentinel's predictions fit the same shape).
    Both paths share this one drift computation.
    """

    def __init__(self, expected_fetch_s: Optional[float] = None,
                 cfg: DetectorConfig = DetectorConfig(),
                 tracer=NULL_TRACER, *, baseline=None):
        if (expected_fetch_s is None) == (baseline is None):
            raise ValueError("pass exactly one of expected_fetch_s or "
                             "baseline=")
        if baseline is None:
            anchor = float(expected_fetch_s)
            baseline = lambda: anchor            # noqa: E731
        self.baseline = baseline
        self.cfg = cfg
        self.tracer = tracer
        self.straggler = StragglerStats(window=cfg.straggler_window,
                                        ratio=cfg.straggler_ratio,
                                        min_samples=cfg.min_samples)
        self.consecutive = 0
        self.detected = False
        self.detect_round: Optional[int] = None

    @property
    def expected_fetch_s(self) -> float:
        """The current expectation (evaluated through the baseline)."""
        return float(self.baseline())

    def drift(self, fetch_total_s: Optional[float]) -> Optional[float]:
        if fetch_total_s is None:
            return None
        expected = self.expected_fetch_s
        if expected <= 0:
            return 1.0
        return fetch_total_s / expected

    def observe(self, rnd: int, t: float,
                fetch_total_s: Optional[float],
                step_times: Sequence[float] = (),
                hard_fail: bool = False,
                corroborated: bool = False) -> bool:
        """Feed one round's evidence; returns the (sticky) detected flag."""
        for dt in step_times:
            self.straggler.record(dt)
        drift = self.drift(fetch_total_s)
        drifting = drift is not None and drift > self.cfg.drift_threshold
        self.consecutive = self.consecutive + 1 if drifting else 0
        if self.tracer.enabled:
            self.tracer.counter(
                "resilience.drift",
                {"fetch_drift": drift if drift is not None else -1.0},
                ts=t, track=("resilience", "detector"), cat="resilience")
            self.tracer.metrics.set("resilience.drift",
                                    drift if drift is not None else -1.0)
        if self.detected:
            return True
        if hard_fail or (drifting and (self.straggler.inflated
                                       or corroborated
                                       or self.consecutive
                                       >= self.cfg.patience)):
            self.detected = True
            self.detect_round = rnd
            if self.tracer.enabled:
                self.tracer.instant(
                    "resilience.detect", ts=t,
                    track=("resilience", "detector"), cat="resilience",
                    round=rnd, drift=drift, hard_fail=hard_fail,
                    corroborated=corroborated,
                    straggler_inflated=self.straggler.inflated)
                self.tracer.metrics.set("resilience.detect_round", rnd)
                self.tracer.metrics.add("resilience.detections", 1)
        return self.detected


# --------------------------------------------------------------------------
# Recovery: replan interleave, migrate pages, shed batch class
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryAction:
    """What one recovery did, and what it cost."""
    round: int
    weights: tuple                   # new (fast, spill) interleave
    migrated_pages: int              # pages pulled off the sick tier
    migration_bytes: int
    migration_s: float               # time those bytes took on the fabric
    shed_batch: bool                 # batch-class offload stream dropped
    prefetch_priority: int           # DMA class page fetches now ride

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class RecoveryController:
    """The "decide + act" half of the loop, over one ``PagedKVCache``.

    ``react`` re-derives the interleave from the *degraded* system
    (``elastic.replan_interleave``), applies it via ``cache.retier`` —
    migrating spilled pages off the sick tier — and returns the action the
    serving loop enforces: batch-class flows shed, page DMAs promoted to
    ``prefetch_priority``. Migration bytes move in the *bulk* class
    (priority 0): evacuation must not starve the interactive fetches it
    exists to protect.
    """

    def __init__(self, cache, *, fast_budget_frac: float = 0.75,
                 prefetch_priority: int = 1, shed_batch: bool = True,
                 tracer=NULL_TRACER):
        self.cache = cache
        self.fast_budget_frac = fast_budget_frac
        self.prefetch_priority = prefetch_priority
        self.shed_batch = shed_batch
        self.tracer = tracer

    def _migration_time(self, system, nbytes: int) -> float:
        """Bulk-class time to move ``nbytes`` spill->fast on ``system``
        (0.0 when nothing moves or no route survives) — executed as a
        one-transfer ``repro_torch.transport`` plan so the migration shows
        up on the same tracer/metrics surface as every other page
        movement."""
        from repro_torch.transport import (PageTransfer, Route,
                                           plan_transfers)

        if nbytes <= 0 or system.kv_tiers is None:
            return 0.0
        route = Route.try_resolve(system, system.kv_tiers[1],
                                  system.compute)
        if route is None or route.effective_bandwidth(()) <= 0:
            return 0.0
        plan = plan_transfers(
            route, (PageTransfer("retier", nbytes),),
            flow_prefix="migrate_", tracer=self.tracer)
        return plan.total_time

    def react(self, system, rnd: int, t: float,
              background: Sequence = (),
              migration_system=None) -> RecoveryAction:
        """Replan + migrate on the degraded ``system``.

        ``migration_system`` overrides where the migration bytes are
        costed: a hot-*removal* drains over the pre-removal fabric (the
        eviction window the CXL survey describes), so the caller passes
        the base system there; a degraded-but-alive link pays the degraded
        price (the default).
        """
        weights = replan_interleave(
            system, background=background,
            priority=self.prefetch_priority,
            fast_budget_frac=self.fast_budget_frac)
        info = self.cache.retier(weights)
        migration_bytes = info["to_fast"] * self.cache.host_page_bytes
        migration_s = self._migration_time(migration_system or system,
                                           migration_bytes)
        # re-materialize the spill shadow under the new assignment so the
        # next round's fetches read real host-resident pages
        self.cache.spill_cold_pages()
        action = RecoveryAction(
            round=rnd, weights=tuple(weights),
            migrated_pages=info["to_fast"],
            migration_bytes=migration_bytes, migration_s=migration_s,
            shed_batch=self.shed_batch,
            prefetch_priority=self.prefetch_priority)
        if self.tracer.enabled:
            self.tracer.instant(
                "resilience.recover", ts=t,
                track=("resilience", "recovery"), cat="resilience",
                round=rnd, weights=list(weights),
                migrated_pages=action.migrated_pages,
                migration_s=migration_s, shed_batch=self.shed_batch)
            m = self.tracer.metrics
            m.set("resilience.recover_round", rnd)
            m.add("resilience.migrated_bytes", migration_bytes)
            m.set("resilience.migration_s", migration_s)
        return action


# --------------------------------------------------------------------------
# The serve loop under degradation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradedServeConfig:
    """Knobs of the degradation serve loop (simulated decode rounds)."""
    requests: int = 6
    prompt: int = 1024
    gen: int = 16
    rounds: int = 12
    page_size: int = 64
    kv_heads: int = 8
    head_dim: int = 128
    weights: tuple = (2, 1)          # pre-event (fast, spill) interleave
    step_us: float = 100.0
    system: str = "tpu_v5e"
    slo_slack: float = 1.6           # SLO = slack x healthy mean completion
    fast_budget_frac: float = 0.75   # capacity pressure for the replanner
    batch_offload_bytes: int = 64 << 20   # our own shed-able bulk stream
    prefetch_priority: int = 0       # pre-event DMA class (egalitarian)
    recovery_target_frac: float = 0.8
    detector: DetectorConfig = DetectorConfig()


@dataclasses.dataclass(frozen=True)
class RoundReport:
    round: int
    t0: float                        # serve-clock time the round starts
    wall_s: float
    tokens_per_s: float
    fetch_total_s: Optional[float]   # None: spill tier gone, fetch stuck
    drift: Optional[float]
    violations: dict                 # seq id -> SLO overrun (s)
    degraded: bool
    detected: bool
    recovered: bool
    action: Optional[dict] = None    # RecoveryAction.to_json() if fired
    top_contributors: Optional[dict] = None   # label -> count (attribution)


@dataclasses.dataclass(frozen=True)
class DegradedServeReport:
    """One full degradation serve run (reacting or baseline)."""
    system: str
    reacted: bool
    rounds: tuple                    # RoundReport per round
    event_round: int
    detect_round: Optional[int]
    recover_round: Optional[int]     # first round back above target
    pre_tput: float                  # tokens/s, mean before the event
    during_min_tput: float           # worst round from the event on
    post_tput: float                 # mean of the trailing rounds
    recovery_frac: float             # post / pre
    detect_latency_rounds: Optional[int]
    recovery_time_s: Optional[float]
    violations_total: int            # SLO misses from the event on
    slo_s: float
    attribution: Optional[dict] = None   # pooled critical-path summary
    slo: Optional[dict] = None           # SLOMonitor.report() snapshot
    drift_routes: Optional[dict] = None  # DriftSentinel.report() snapshot
    recal: Optional[tuple] = None        # RecalResult.to_json() + post_ratios

    def to_json(self) -> dict:
        out = {
            "system": self.system, "reacted": self.reacted,
            "event_round": self.event_round,
            "detect_round": self.detect_round,
            "recover_round": self.recover_round,
            "pre_tput_tok_s": round(self.pre_tput, 1),
            "during_min_tput_tok_s": round(self.during_min_tput, 1),
            "post_tput_tok_s": round(self.post_tput, 1),
            "recovery_frac": round(self.recovery_frac, 4),
            "detect_latency_rounds": self.detect_latency_rounds,
            "recovery_time_s": self.recovery_time_s,
            "violations_total": self.violations_total,
            "slo_s": self.slo_s,
            "rounds": [dataclasses.asdict(r) for r in self.rounds],
        }
        if self.attribution is not None:
            out["attribution"] = self.attribution
        if self.slo is not None:
            out["slo"] = self.slo
        if self.drift_routes is not None:
            out["drift_routes"] = self.drift_routes
        if self.recal is not None:
            out["recal"] = list(self.recal)
        return out


def _build_cache(cfg: DegradedServeConfig, tracer, device: torch.device):
    from repro_torch.serving.pager import PagedKVCache, PagerConfig

    toks = cfg.prompt + cfg.gen
    pages_per_seq = -(-toks // cfg.page_size)
    n_pages = cfg.requests * pages_per_seq + 8
    cache = PagedKVCache(PagerConfig(
        page_size=cfg.page_size, n_pages=n_pages, kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, weights=cfg.weights, dtype="bfloat16",
        prefetch_priority=cfg.prefetch_priority), tracer=tracer,
        device=device)
    kv = torch.zeros((toks, cfg.kv_heads, cfg.head_dim),
                     dtype=torch.bfloat16, device=device)
    for s in range(cfg.requests):
        cache.allocate(s)
        cache.append(s, kv, kv)
    cache.spill_cold_pages()
    return cache


def run_degraded_serve(schedule: DegradationSchedule, *,
                       cfg: DegradedServeConfig = DegradedServeConfig(),
                       react: bool = True, calibration_profile=None,
                       slo=None, sentinel=None, recorder=None,
                       recalibrate: bool = False,
                       tracer=NULL_TRACER,
                       device=None) -> DegradedServeReport:
    """Serve ``cfg.rounds`` simulated decode rounds while ``schedule``
    degrades the fabric; detect and (if ``react``) recover.

    Each round replays the same request set through ``DecodeScheduler``
    on the system *as that round sees it* (``schedule.degraded_system``),
    with round-local SLO deadlines set to ``slo_slack`` x the healthy
    mean completion. The no-reaction baseline (``react=False``) runs the
    detector for reporting but never acts — the control arm every
    recovery claim is judged against.

    ``calibration_profile`` (a ``CalibrationProfile`` or a path to its
    JSON artifact) anchors the expected fetch time (and every plan) on the
    calibrated machine's fitted link constants.

    The cache's pools live on ``device`` (default ``cuda``; raises if
    there is none); every time in the report is simulated on the
    ``cfg.system`` preset.

    Observability hooks (all optional, all fed live inside the loop):
    ``slo`` is a ``repro_torch.obs.SLOMonitor`` (one built on the tracer when
    tracing) fed each sequence's round completion under class
    ``"interactive"``; with a tracer the per-round critical-path
    attribution runs on the round's own event slice, its top contributors
    land on each ``RoundReport``, and an SLO burn alert whose violating
    requests blame a link corroborates the drift detector (so it can fire
    a round earlier than bare patience). ``sentinel`` is a
    ``repro_torch.obs.DriftSentinel`` replaying each round's prefetch plan;
    ``recorder`` is a ``repro_torch.obs.FlightRecorder`` — used as the tracer
    when none was passed, and snapshotted (with the violating requests'
    attribution attached) at the first detector fire and the first
    alerting SLO window.

    ``recalibrate=True`` (needs ``sentinel`` + ``calibration_profile``)
    closes the drift loop: the sentinel's sticky flag triggers an
    ``AutoRecalibrator`` that re-probes only the flagged route against
    the round's live (degraded) fabric, refits, hot-swaps the constants
    into the sentinel's expectation and the detector's fetch anchor, and
    acknowledges the flag — so the drift ratio converges back to ~1.0 on
    the machine as it now is. Each swap lands in the report's ``recal``
    entries with the route's subsequent drift ratios.
    """
    from repro_torch.fabric.contention import Flow
    from repro_torch.fabric.systems import from_profile, get_system
    from repro_torch.launch.serve import DecodeScheduler
    from repro_torch.obs.attribution import (attribute_requests,
                                             attribution_summary,
                                             event_cursor, events_since)

    if recalibrate and (sentinel is None or calibration_profile is None):
        raise ValueError("recalibrate=True needs both sentinel= and "
                         "calibration_profile= (the flag source and "
                         "the profile to refit)")
    device = resolve_device(device)
    if recorder is not None and not tracer.enabled:
        tracer = recorder

    if calibration_profile is not None:
        from repro_torch.calibrate.profile import load_profile
        calibration_profile = load_profile(calibration_profile)
        base = from_profile(calibration_profile, preset=cfg.system)
    else:
        base = get_system(cfg.system)
    if base.kv_tiers is None:
        raise ValueError(f"{cfg.system} has no spill tier: nothing to "
                         "degrade or recover")
    step_s = cfg.step_us * 1e-6
    seqs = list(range(cfg.requests))
    cache = _build_cache(cfg, tracer, device)
    own_bg = Flow("batch_offload", base.kv_tiers[1], base.kv_tiers[0],
                  nbytes=cfg.batch_offload_bytes)

    # Healthy reference: expected fetch (the detector's anchor) and the
    # SLO, both under the machine's normal contention.
    ref = DecodeScheduler(cache, system=base, background=(own_bg,),
                          step_time=step_s,
                          priority=cfg.prefetch_priority)
    ref_sched = ref.schedule(seqs, cfg.gen)
    slo_s = cfg.slo_slack * ref_sched.mean_completion

    # mutable anchor: auto-recalibration hot-swaps the expected fetch
    # time when the spill route's constants are refit mid-serve
    anchor = {"fetch_s": ref_sched.prefetch_total}
    detector = DegradationDetector(cfg=cfg.detector, tracer=tracer,
                                   baseline=lambda: anchor["fetch_s"])

    recal_ctl = None
    pending_recal: list = []
    recal_records: list = []
    if recalibrate:
        from repro_torch.calibrate.recal import AutoRecalibrator
        recal_ctl = AutoRecalibrator(calibration_profile,
                                     preset=cfg.system, sentinel=sentinel,
                                     tracer=tracer)
        prev_on_flag = sentinel.on_flag

        def _queue_recal(route, info, _prev=prev_on_flag):
            if _prev is not None:
                _prev(route, info)
            pending_recal.append(route)

        sentinel.on_flag = _queue_recal
    fetch_route_key = f"{base.tier_node(base.kv_tiers[1])}->{base.compute}"
    ref_plan = getattr(ref_sched.plan, "transfer_plan", ref_sched.plan)
    ref_wire_bytes = float(getattr(ref_plan, "wire_bytes", 0) or 4 << 20)

    recovery = RecoveryController(
        cache, fast_budget_frac=cfg.fast_budget_frac,
        prefetch_priority=max(1, cfg.prefetch_priority + 1),
        tracer=tracer)
    monitor = slo
    if monitor is None and tracer.enabled:
        from repro_torch.obs.slo import SLOMonitor
        monitor = SLOMonitor(tracer=tracer)
    if monitor is not None:
        monitor.add_class("interactive", slo_s=slo_s)

    rounds: list[RoundReport] = []
    viol_attrs: dict = {}            # (round, seq) -> RequestAttribution
    snapped_detect = snapped_slo = False
    t = 0.0
    prio = cfg.prefetch_priority
    shed = False
    recovered = False
    recover_action: Optional[RecoveryAction] = None
    for r in range(cfg.rounds):
        sys_r = schedule.degraded_system(base, r)
        degraded = (bool(schedule.scales_at(r))
                    or bool(schedule.removed_tiers_at(r))
                    or bool(schedule.co_flows_at(r)))
        spill_gone = sys_r.kv_tiers is None
        stranded = spill_gone and bool(cache.host_pages(seqs))
        action_json = None
        migration_charge = 0.0

        if stranded and react:
            # hard failure: the tier the pages live on is gone — detect
            # immediately and evacuate over the pre-removal fabric (the
            # eviction window), before anything can be scheduled
            detector.observe(r, t, None, hard_fail=True)
            recover_action = recovery.react(sys_r, r, t, background=(),
                                            migration_system=base)
            recovered, shed = True, True
            prio = recover_action.prefetch_priority
            migration_charge = recover_action.migration_s
            action_json = recover_action.to_json()
            stranded = False

        if stranded:
            # baseline with its pages on a removed tier: the round stalls
            # out its whole SLO window with nothing served
            detector.observe(r, t, None, hard_fail=True)
            if monitor is not None:
                for s in seqs:
                    monitor.observe("interactive", slo_s, ts=t + slo_s,
                                    violated=True)
            rounds.append(RoundReport(
                round=r, t0=t, wall_s=slo_s, tokens_per_s=0.0,
                fetch_total_s=None, drift=None,
                violations={s: slo_s for s in seqs}, degraded=True,
                detected=detector.detected, recovered=False))
            t += slo_s
            continue

        bg = () if (shed or spill_gone) else (own_bg,)
        bg = bg + schedule.co_flows_at(r)
        n0 = event_cursor(tracer) if tracer.enabled else 0
        sched = DecodeScheduler(
            cache, system=sys_r, background=bg, step_time=step_s,
            priority=prio, tracer=tracer).schedule(
                seqs, cfg.gen, deadlines={s: slo_s for s in seqs})
        step_times = [sched.finish_time[s] / cfg.gen for s in seqs]

        # Round-local observability: attribution on this round's event
        # slice, SLO feed, drift-sentinel plan replay — before the
        # detector, so a burning SLO whose violators blame a link can
        # corroborate it this very round.
        viol = sorted(sched.violations)
        attrs: dict = {}
        tops = None
        if tracer.enabled:
            attrs = attribute_requests(events_since(tracer, n0))
        if monitor is not None:
            for s in seqs:
                monitor.observe("interactive", sched.finish_time[s],
                                ts=t + sched.finish_time[s],
                                violated=s in sched.violations)
        if sentinel is not None:
            plan_r = getattr(sched.plan, "transfer_plan", sched.plan)
            if getattr(plan_r, "transfers", ()):
                ratio = sentinel.observe_plan(plan_r, background=bg, ts=t)
                if ratio is not None:
                    route_lbl = plan_r.route.label
                    for rec in recal_records:
                        if rec["route"] == route_lbl \
                                and rec["round"] < r:
                            rec["post_ratios"].append(round(ratio, 6))
            if recal_ctl is not None and pending_recal:
                # the drift loop's react leg: re-probe only the flagged
                # route on this round's live fabric, hot-swap, ack
                for route_key in pending_recal:
                    res = recal_ctl.recalibrate(route_key,
                                                truth_system=sys_r, ts=t)
                    if route_key == fetch_route_key:
                        anchor["fetch_s"] *= res.time_scale(
                            ref_wire_bytes)
                    rec = res.to_json()
                    rec["round"] = r
                    rec["post_ratios"] = []
                    recal_records.append(rec)
                pending_recal.clear()
        corroborated = False
        if attrs and monitor is not None \
                and monitor.alerting("interactive"):
            vt = [attrs[s].top_contributor for s in viol if s in attrs]
            blamed = [x for x in vt if x and x.startswith("link_wait:")]
            corroborated = bool(vt) and len(blamed) * 2 > len(vt)
        if attrs:
            for s in viol:
                if s in attrs:
                    viol_attrs[(r, s)] = attrs[s]
            tops = {}
            for s in (viol or seqs):
                a = attrs.get(s)
                if a is not None and a.top_contributor is not None:
                    tops[a.top_contributor] = \
                        tops.get(a.top_contributor, 0) + 1

        detected = detector.observe(r, t, sched.prefetch_total,
                                    step_times=step_times,
                                    corroborated=corroborated)
        if recorder is not None and attrs:
            summary = attribution_summary(attrs,
                                          rids=viol if viol else None)
            if detected and not snapped_detect:
                snapped_detect = True
                recorder.snapshot(reason=f"detector_fire:round{r}", ts=t,
                                  attribution=summary)
            if (not snapped_slo and viol and monitor is not None
                    and monitor.alerting("interactive")):
                snapped_slo = True
                recorder.snapshot(reason=f"slo_violation:round{r}", ts=t,
                                  attribution=summary)

        if detected and react and not recovered:
            # act at the round boundary: replan on the degraded fabric,
            # migrate, shed our own bulk stream, promote the DMA class —
            # the migration bytes are charged to this round's wall
            recover_action = recovery.react(sys_r, r, t, background=bg)
            recovered, shed = True, True
            prio = recover_action.prefetch_priority
            migration_charge = recover_action.migration_s
            action_json = recover_action.to_json()

        wall = sched.makespan + migration_charge
        tput = cfg.requests * cfg.gen / wall if wall > 0 else 0.0
        if tracer.enabled:
            tracer.counter("resilience.tput",
                           {"tokens_per_s": tput}, ts=t,
                           track=("resilience", "serve"), cat="resilience")
        rounds.append(RoundReport(
            round=r, t0=t, wall_s=wall, tokens_per_s=tput,
            fetch_total_s=sched.prefetch_total,
            drift=detector.drift(sched.prefetch_total),
            violations=dict(sched.violations), degraded=degraded,
            detected=detected, recovered=recovered, action=action_json,
            top_contributors=tops))
        t += wall

    event_round = schedule.first_event_round
    pre = [rr.tokens_per_s for rr in rounds if rr.round < event_round]
    pre_tput = sum(pre) / len(pre) if pre else 0.0
    during = [rr for rr in rounds if rr.round >= event_round]
    during_min = min((rr.tokens_per_s for rr in during), default=0.0)
    tail = rounds[-2:] if len(rounds) >= 2 else rounds
    post_tput = sum(rr.tokens_per_s for rr in tail) / max(len(tail), 1)
    recovery_frac = post_tput / pre_tput if pre_tput > 0 else 0.0
    target = cfg.recovery_target_frac * pre_tput
    recover_round = next((rr.round for rr in during
                          if rr.tokens_per_s >= target), None)
    recovery_time = None
    if recover_round is not None:
        t_event = next(rr.t0 for rr in rounds if rr.round == event_round)
        t_rec = next(rr.t0 for rr in rounds if rr.round == recover_round)
        recovery_time = t_rec - t_event
    violations_total = sum(len(rr.violations) for rr in during)
    detect_latency = (detector.detect_round - event_round
                      if detector.detect_round is not None else None)
    if tracer.enabled:
        m = tracer.metrics
        m.set("resilience.recovery_frac", recovery_frac)
        m.set("resilience.violations_total", violations_total)
    attribution = attribution_summary(viol_attrs) if viol_attrs else None
    return DegradedServeReport(
        system=cfg.system, reacted=react, rounds=tuple(rounds),
        event_round=event_round, detect_round=detector.detect_round,
        recover_round=recover_round, pre_tput=pre_tput,
        during_min_tput=during_min, post_tput=post_tput,
        recovery_frac=recovery_frac,
        detect_latency_rounds=detect_latency,
        recovery_time_s=recovery_time,
        violations_total=violations_total, slo_s=slo_s,
        attribution=attribution,
        slo=monitor.report() if monitor is not None else None,
        drift_routes=sentinel.report() if sentinel is not None else None,
        recal=tuple(recal_records) if recal_records else None)
