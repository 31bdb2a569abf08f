"""resilience benchmark family — the degradation reaction loop's report
card.

The port of the reference's ``repro/heimdall/resilience.py``: the same rows
and summary. Every time but the detector's overhead is simulated on the
``tpu_v5e`` preset; each run's pager holds its pools on ``device``
(default ``cuda``), and the reacting runs' recovery moves its pages there.

The claim under test: with the host link halved
mid-serve, the stack detects within the configured window and recovers to
>= 80% of pre-event decode throughput, while holding interactive-class SLO
violations during the event *strictly below* the no-reaction baseline.
Three scenarios and one overhead row:

  * ``resilience_recovery``  — the headline: host link halved at round 4
                               (``host_link_degraded``); recovery fraction
                               and detection latency, react vs baseline.
  * ``resilience_slo``       — the same runs' deadline accounting: SLO
                               violations from the event on, react must be
                               < baseline.
  * ``resilience_hot_remove``— the spill tier hot-removed outright (the
                               CXL survey's pooled-expander event): the
                               reacting run evacuates and keeps serving;
                               the baseline flatlines.
  * ``resilience_co_tenant`` — a noisy co-tenant stream appears then
                               leaves; the reacting run re-classes its DMA
                               and sheds bulk to ride it out.
  * ``resilience_detector_overhead`` — steady-state cost of one healthy
                               ``DegradationDetector.observe`` call (the
                               per-round tax every serve pays, capped).

``resilience_summary()`` condenses the family into the reference's
``BENCH_resilience.json`` schema.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.heimdall.harness import Row, time_fn_stats
from repro_torch.models.context import resolve_device

# Thresholds BENCH_resilience.json is held to.
MIN_RECOVERY_FRAC = 0.8          # post-event tput / pre-event tput
MAX_DETECT_ROUNDS = 3            # rounds from event to detection
MAX_DETECTOR_OVERHEAD_US = 500.0  # one healthy observe() call


def _serve_cfg():
    from repro_torch.runtime.degrade import DegradedServeConfig
    return DegradedServeConfig(requests=6, prompt=1024, gen=16, rounds=12)


def _pair(sched, device: torch.device) -> tuple:
    from repro_torch.runtime.degrade import run_degraded_serve
    cfg = _serve_cfg()
    return (run_degraded_serve(sched, cfg=cfg, react=True, device=device),
            run_degraded_serve(sched, cfg=cfg, react=False, device=device))


@functools.lru_cache(maxsize=2)
def _headline(device: torch.device) -> tuple:
    """(react, baseline) reports for the headline host-link-halved
    scenario — one pair of runs shared by the recovery and SLO rows and
    the JSON summary."""
    from repro_torch.runtime.degrade import host_link_degraded
    sched = host_link_degraded(system=_serve_cfg().system, at_round=4,
                               factor=0.5)
    return _pair(sched, device)


@functools.lru_cache(maxsize=2)
def _hot_remove(device: torch.device) -> tuple:
    from repro_torch.runtime.degrade import DegradationSchedule, tier_removed
    return _pair(DegradationSchedule((tier_removed(4, "host"),)), device)


@functools.lru_cache(maxsize=2)
def _co_tenant(device: torch.device) -> tuple:
    from repro_torch.fabric.contention import Flow
    from repro_torch.runtime.degrade import DegradationSchedule, co_tenant
    noisy = Flow("noisy_neighbor", "host", "hbm", nbytes=0)
    return _pair(DegradationSchedule((co_tenant(4, noisy, until_round=10),)),
                 device)


def _pair_rows(label: str, react, base) -> list:
    return [
        Row(f"resilience_{label}/react", react.recovery_time_s or 0.0,
            f"recovery_frac={react.recovery_frac:.3f};"
            f"detect_round={react.detect_round};"
            f"violations={react.violations_total}"),
        Row(f"resilience_{label}/baseline", 0.0,
            f"recovery_frac={base.recovery_frac:.3f};"
            f"violations={base.violations_total}"),
    ]


def resilience_recovery(device=None) -> list:
    """Headline: detection latency + recovery fraction, react vs
    baseline (us column = recovery time in s for the react row)."""
    react, base = _headline(resolve_device(device))
    rows = _pair_rows("recovery", react, base)
    rows.append(Row(
        "resilience_recovery/detect",
        (react.detect_latency_rounds or 0) * 1.0,
        f"latency_rounds={react.detect_latency_rounds};"
        f"window={MAX_DETECT_ROUNDS};"
        f"event_round={react.event_round}"))
    return rows


def resilience_slo(device=None) -> list:
    """Interactive deadline violations during the event, react vs
    baseline — the number QoS + recovery exist to hold down."""
    react, base = _headline(resolve_device(device))
    return [Row(
        "resilience_slo/violations", 0.0,
        f"react={react.violations_total};"
        f"baseline={base.violations_total};"
        f"slo_s={react.slo_s:.6f}")]


def resilience_hot_remove(device=None) -> list:
    react, base = _hot_remove(resolve_device(device))
    return _pair_rows("hot_remove", react, base)


def resilience_co_tenant(device=None) -> list:
    react, base = _co_tenant(resolve_device(device))
    return _pair_rows("co_tenant", react, base)


def resilience_detector_overhead() -> list:
    """Steady-state per-round cost of the detector on a healthy fabric —
    the tax a serve pays for being watchable."""
    from repro_torch.runtime.degrade import DegradationDetector

    det = DegradationDetector(expected_fetch_s=1e-3)
    rnd = [0]

    def observe():
        r = rnd[0]
        rnd[0] += 1
        det.observe(r, r * 1e-3, 1e-3,
                    step_times=(1e-4,) * 6)

    t = time_fn_stats(observe, warmup=5, iters=50, inner=10,
                      max_dispersion=0.5)
    us = t.median * 1e6
    return [Row("resilience_detector/observe_us", us,
                f"threshold={MAX_DETECTOR_OVERHEAD_US};"
                f"detected={det.detected}", n_reruns=t.n_reruns)]


ALL_RESILIENCE = [resilience_recovery, resilience_slo,
                  resilience_hot_remove, resilience_co_tenant,
                  resilience_detector_overhead]


def resilience_summary(device=None) -> dict:
    """The BENCH_resilience.json payload: recovery fraction, detection
    latency, and SLO-violation ordering for the headline scenario, with
    the hot-remove / co-tenant runs and detector overhead (wall clock)
    riding along."""
    device = resolve_device(device)
    react, base = _headline(device)
    hr_react, hr_base = _hot_remove(device)
    ct_react, ct_base = _co_tenant(device)
    det_row = resilience_detector_overhead()[0]
    cfg = _serve_cfg()
    return {
        "family": "resilience",
        "system": cfg.system,
        "scenario": {
            "event": "host link x0.5 at round 4",
            "requests": cfg.requests, "gen": cfg.gen,
            "rounds": cfg.rounds, "slo_slack": cfg.slo_slack,
            "prefetch_priority_pre": cfg.prefetch_priority,
        },
        "detect": {
            "round": react.detect_round,
            "latency_rounds": react.detect_latency_rounds,
            "window_rounds": MAX_DETECT_ROUNDS,
        },
        "recovery": {
            "frac": react.recovery_frac,
            "baseline_frac": base.recovery_frac,
            "time_s": react.recovery_time_s,
            "target_frac": MIN_RECOVERY_FRAC,
            "pre_tput_tok_s": react.pre_tput,
            "post_tput_tok_s": react.post_tput,
        },
        "slo": {
            "violations_react": react.violations_total,
            "violations_baseline": base.violations_total,
            "slo_s": react.slo_s,
        },
        "hot_remove": {
            "react_recovery_frac": hr_react.recovery_frac,
            "react_violations": hr_react.violations_total,
            "baseline_recovery_frac": hr_base.recovery_frac,
            "baseline_violations": hr_base.violations_total,
        },
        "co_tenant": {
            "react_recovery_frac": ct_react.recovery_frac,
            "react_violations": ct_react.violations_total,
            "baseline_violations": ct_base.violations_total,
        },
        "detector_overhead_us": det_row.us_per_call,
        "thresholds": {
            "min_recovery_frac": MIN_RECOVERY_FRAC,
            "max_detect_rounds": MAX_DETECT_ROUNDS,
            "max_detector_overhead_us": MAX_DETECTOR_OVERHEAD_US,
        },
    }
