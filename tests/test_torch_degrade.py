"""repro_torch.runtime (elastic, degrade) vs the reference's, on the CPU.

The degradation loop plans on the fabric simulator, so every value in its
reports is simulated and depends on tier assignments, page counts and the
fabric, never on page values: the port must give the reference's reports
exactly (the same JSON text, floats compared with ``==``), its trace events
and metrics too. The port's pagers hold their pools on ``device="cpu"``.

The reference's ``PagedKVCache.fetch_spilled`` raises under the installed
jax (it gathers a host-memory pool with a device-memory index), so its
recovery step (``retier`` fetches the spilled pages back) cannot run as
shipped. ``patch_reference_fetch`` replaces that one method, for the
duration of a test, with an fp-only stand-in: the same rows gathered with
numpy on the host, the same ``.at[idx].set``, span and metrics. Nothing
under ``src/repro/`` changes. The reference's own degraded-serve tests
(``tests/test_resilience.py``) are also held on the port, without it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

PRESETS = ["dual_socket_cxl", "cxl_pool", "gh200", "mi300a", "tpu_v5e"]
KV_PRESETS = ["cxl_pool", "dual_socket_cxl", "gh200", "tpu_v5e"]
FAST = dict(requests=4, prompt=512, gen=8, rounds=10)


def patch_reference_fetch(monkeypatch) -> None:
    """Make the reference pager's fp fetch runnable under the installed jax
    (see the module docstring)."""
    import jax.numpy as jnp

    from repro.serving import pager

    def fetch_spilled(self):
        if not self._spilled or not self._host_mask.any():
            return
        assert self.cfg.kv_dtype is None, "the stand-in is fp only"
        n_pages = int(self._host_mask.sum())
        with self.tracer.span("pager.fetch", track=("pager", "tiers"),
                              cat="pager", pages=n_pages):
            idx = self._host_idx
            k_h = jnp.asarray(np.asarray(self.k_pool_host)[idx])
            v_h = jnp.asarray(np.asarray(self.v_pool_host)[idx])
            self.k_pool = self.k_pool.at[jnp.asarray(idx)].set(k_h)
            self.v_pool = self.v_pool.at[jnp.asarray(idx)].set(v_h)
        self._quant_pools = None
        self._spilled = False
        self.tracer.metrics.add("pager.fetch.pages", n_pages, tier="host")
        self.tracer.metrics.add("pager.fetch.bytes",
                                n_pages * self.host_page_bytes, tier="host")

    monkeypatch.setattr(pager.PagedKVCache, "fetch_spilled", fetch_spilled)


def text(x) -> str:
    return json.dumps(x, sort_keys=True, default=_plain)


def _plain(x):
    if hasattr(x, "to_json"):
        return x.to_json()
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    raise TypeError(f"cannot compare {type(x).__name__}")


def _events(tracer) -> list:
    return [tuple(e) for e in tracer.events]


def _sides():
    import repro.fabric.contention as rc
    import repro.fabric.systems as rs
    import repro.obs as ro
    import repro.runtime.degrade as rd
    import repro.runtime.elastic as re_
    import repro_torch.fabric.contention as pc
    import repro_torch.fabric.systems as ps
    import repro_torch.obs as po
    import repro_torch.runtime.degrade as pd
    import repro_torch.runtime.elastic as pe
    return ({"sys": rs, "flow": rc.Flow, "obs": ro, "deg": rd, "el": re_},
            {"sys": ps, "flow": pc.Flow, "obs": po, "deg": pd, "el": pe})


def same(fn):
    """``fn(side)`` for the reference and the port, equal as JSON text;
    returns the port's."""
    want, got = (fn(s) for s in _sides())
    assert text(got) == text(want)
    return got


def raises_same(fn):
    """``fn(side)`` raises the same exception type and message on both."""
    msgs = []
    for s in _sides():
        with pytest.raises(Exception) as e:
            fn(s)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]
    return msgs[1]


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 16, 48, 256])
def test_plan_mesh_and_replan_match_reference(n):
    def go(s):
        import importlib
        base = importlib.import_module(
            s["el"].__name__.split(".")[0] + ".config.base")
        cfg = base.get_config("yi-9b")
        shape = base.ShapeConfig("t", 128, 96, "train")
        return {"mesh": s["el"].plan_mesh(n),
                "mesh4": s["el"].plan_mesh(n, prefer_model=4, min_model=2),
                "replan": s["el"].replan(cfg, shape, n),
                "prev": s["el"].replan(cfg, shape, n, prev_global_batch=7)}
    same(go)


def _bg(s, system):
    """A best-effort stream on the spill route and a prioritized one."""
    if system.kv_tiers is None:
        return ()
    fast, slow = system.kv_tiers
    return (s["flow"]("bulk", slow, fast, nbytes=64 << 20),
            s["flow"]("hot", slow, fast, nbytes=8 << 20, priority=2))


@pytest.mark.parametrize("name", PRESETS)
def test_degraded_tier_bandwidths_match_reference(name):
    def go(s):
        system = s["sys"].get_system(name)
        out = {"quiet": s["el"].degraded_tier_bandwidths(system),
               "loaded": s["el"].degraded_tier_bandwidths(
                   system, _bg(s, system), weight=2.0, priority=1)}
        if system.kv_tiers is not None:
            gone = s["deg"].DegradationSchedule(
                (s["deg"].tier_removed(0, system.kv_tiers[1]),))
            out["removed"] = s["el"].degraded_tier_bandwidths(
                gone.degraded_system(system, 0))
            half = s["deg"].host_link_degraded(name, at_round=0, factor=0.25)
            out["halved"] = s["el"].degraded_tier_bandwidths(
                half.degraded_system(system, 0), _bg(s, system))
        return out
    same(go)


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("kw", [
    {}, {"priority": 1}, {"compression": 2.0}, {"fast_budget_frac": 0.75},
    {"fast_budget_frac": 0.5, "max_weight": 4, "weight": 3.0}])
def test_replan_interleave_matches_reference(name, kw):
    def go(s):
        system = s["sys"].get_system(name)
        out = {"nominal": s["el"].replan_interleave(system, **kw),
               "loaded": s["el"].replan_interleave(system, _bg(s, system),
                                                   **kw)}
        if system.kv_tiers is not None:
            for label, sched in (
                    ("halved", s["deg"].host_link_degraded(
                        name, at_round=0, factor=0.1)),
                    ("removed", s["deg"].DegradationSchedule(
                        (s["deg"].tier_removed(0, system.kv_tiers[1]),)))):
                out[label] = s["el"].replan_interleave(
                    sched.degraded_system(system, 0), _bg(s, system), **kw)
        return out
    same(go)


def test_replan_interleave_rejects_a_bad_budget():
    for frac in (0.0, 1.5):
        raises_same(lambda s: s["el"].replan_interleave(
            s["sys"].get_system("tpu_v5e"), fast_budget_frac=frac))


# ---------------------------------------------------------------------------
# injection: events, schedules, the degraded system
# ---------------------------------------------------------------------------


def _schedule(s):
    d = s["deg"]
    return d.DegradationSchedule((
        d.link_degrade(3, "host_dram", "chip0", 0.5),
        d.link_degrade(5, "chip0", "host_dram", 0.5, until_round=7),
        d.co_tenant(4, s["flow"]("noisy", "host", "hbm"), until_round=6),
        d.tier_removed(9, "host")))


def test_schedule_matches_reference():
    def go(s):
        sched = _schedule(s)
        return {"events": [dataclasses.asdict(e) for e in sched.events],
                "first": sched.first_event_round,
                "rounds": [{"scales": sorted(sched.scales_at(r).items()),
                            "removed": sched.removed_tiers_at(r),
                            "flows": [f.id for f in sched.co_flows_at(r)],
                            "active": [e.active_at(r) for e in sched.events]}
                           for r in range(11)]}
    got = same(go)
    assert got["rounds"][5]["scales"][0][1][0] == pytest.approx(0.25)


def _system_view(system) -> dict:
    return {"name": system.name, "fabric": system.fabric.name,
            "tier_map": system.tier_map, "kv_tiers": system.kv_tiers,
            "nodes": sorted(system.fabric.nodes),
            "links": sorted((k, v.bandwidth, v.latency)
                            for k, v in system.fabric.links.items())}


def test_degraded_system_matches_reference():
    def go(s):
        base = s["sys"].get_system("tpu_v5e")
        sched = _schedule(s)
        return [_system_view(sched.degraded_system(base, r))
                for r in range(11)]
    got = same(go)
    assert got[9]["kv_tiers"] is None and "host" not in got[9]["tier_map"]


@pytest.mark.parametrize("name", KV_PRESETS)
def test_host_link_degraded_matches_reference(name):
    def go(s):
        sched = s["deg"].host_link_degraded(name, at_round=2, factor=0.3)
        base = s["sys"].get_system(name)
        return {"events": [dataclasses.asdict(e) for e in sched.events],
                "system": _system_view(sched.degraded_system(base, 2)),
                "before": _system_view(sched.degraded_system(base, 1))}
    same(go)


@pytest.mark.parametrize("case", [
    "bad_kind", "no_link", "no_factor", "no_tier", "no_flow",
    "unknown_link", "unknown_tier", "fast_removed", "no_spill_tier"])
def test_injection_errors_match_reference(case):
    def go(s):
        d = s["deg"]
        base = s["sys"].get_system("tpu_v5e")
        if case == "bad_kind":
            d.DegradationEvent(0, "meteor")
        elif case == "no_link":
            d.DegradationEvent(0, "link_degrade")
        elif case == "no_factor":
            d.link_degrade(0, "chip0", "host_dram", 0.0)
        elif case == "no_tier":
            d.DegradationEvent(0, "tier_removed")
        elif case == "no_flow":
            d.DegradationEvent(0, "co_tenant")
        elif case == "unknown_link":
            d.DegradationSchedule((d.link_degrade(0, "chip0", "hbm1", 0.5),)
                                  ).degraded_system(base, 0)
        elif case == "unknown_tier":
            d.DegradationSchedule((d.tier_removed(0, "nvram"),)
                                  ).degraded_system(base, 0)
        elif case == "fast_removed":
            d.DegradationSchedule((d.tier_removed(1, "hbm"),)
                                  ).degraded_system(base, 1)
        else:
            d.host_link_degraded("mi300a")
    kind, _ = raises_same(go)
    assert kind == "ValueError"


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


def _feed(det, evidence):
    return [det.observe(*ev[:3], **ev[3]) for ev in evidence]


# tests/test_resilience.py's detector paths, plus corroboration and the
# straggler signal
DETECTOR_CASES = {
    "healthy": ({"patience": 2},
                [(r, r * 1e-3, 1.05e-3, {"step_times": (1e-4,) * 6})
                 for r in range(20)]),
    "patience": ({"patience": 2, "min_samples": 100},
                 [(0, 0.0, 2e-3, {}), (1, 1e-3, 2e-3, {}),
                  (2, 2e-3, 1e-3, {})]),
    "reset": ({"patience": 2, "min_samples": 100},
              [(0, 0.0, 2e-3, {}), (1, 1e-3, 1e-3, {}),
               (2, 2e-3, 2e-3, {})]),
    "hard_fail": ({"patience": 5}, [(3, 0.0, None, {"hard_fail": True})]),
    "corroborated": ({"patience": 5, "min_samples": 100},
                     [(0, 0.0, 1e-3, {}),
                      (1, 1e-3, 2e-3, {"corroborated": True})]),
    "straggler": ({"patience": 9, "min_samples": 4, "straggler_window": 8},
                  [(r, r * 1e-3, 1e-3 if r < 3 else 1.5e-3,
                    {"step_times": (1e-4,) * 3 if r < 3 else (9e-4,) * 3})
                   for r in range(8)]),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
@pytest.mark.parametrize("traced", [False, True])
def test_detector_matches_reference(case, traced):
    kw, evidence = DETECTOR_CASES[case]

    def go(s):
        d = s["deg"]
        tr = s["obs"].Tracer(clock=lambda: 0.0)
        det = d.DegradationDetector(1e-3, d.DetectorConfig(**kw),
                                    tracer=tr if traced else
                                    s["obs"].NULL_TRACER)
        flags = _feed(det, evidence)
        return {"flags": flags, "round": det.detect_round,
                "drift": [det.drift(ev[2]) for ev in evidence],
                "events": _events(tr), "metrics": tr.metrics.to_json()}
    got = same(go)
    assert any(got["flags"]) == (case != "healthy" and case != "reset")


def test_detector_baselines_match_reference():
    def go(s):
        d = s["deg"]
        system = s["sys"].get_system("tpu_v5e")
        base = d.calibration_baseline(system, 4 << 20,
                                      background=_bg(s, system),
                                      priority=1)
        det = d.DegradationDetector(baseline=base)
        flags = [det.observe(r, 0.0, base() * f)
                 for r, f in enumerate((1.0, 1.5, 1.5, 1.0))]
        return {"expected": det.expected_fetch_s, "flags": flags,
                "round": det.detect_round}
    same(go)
    for kw in ({}, {"expected_fetch_s": 1.0, "baseline": lambda: 1.0}):
        raises_same(lambda s: s["deg"].DegradationDetector(**kw))
    raises_same(lambda s: s["deg"].calibration_baseline(
        s["sys"].get_system("mi300a"), 1))


# ---------------------------------------------------------------------------
# the loop end to end
# ---------------------------------------------------------------------------


def _scenario(s, name, at_round=3):
    d = s["deg"]
    if name == "headline":
        return d.host_link_degraded(at_round=at_round)
    if name == "hot_remove":
        return d.DegradationSchedule((d.tier_removed(at_round, "host"),))
    return d.DegradationSchedule((d.co_tenant(
        at_round, s["flow"]("noisy", "host", "hbm", nbytes=0),
        until_round=at_round + 5),))


def _serve(s, scenario, react, tracer=None, **kw):
    d = s["deg"]
    if s["deg"].__name__.startswith("repro_torch"):
        kw["device"] = "cpu"
    if tracer is not None:
        kw["tracer"] = tracer
    return d.run_degraded_serve(_scenario(s, scenario), react=react,
                                cfg=d.DegradedServeConfig(**FAST), **kw)


@pytest.mark.parametrize("scenario", ["headline", "hot_remove", "co_tenant"])
@pytest.mark.parametrize("react", [True, False])
@pytest.mark.parametrize("traced", [False, True])
def test_degraded_serve_matches_reference(monkeypatch, scenario, react,
                                          traced):
    patch_reference_fetch(monkeypatch)

    def go(s):
        tr = s["obs"].Tracer(clock=lambda: 0.0) if traced else None
        rep = _serve(s, scenario, react, tr)
        out = {"report": rep.to_json()}
        if traced:
            out["events"] = _events(tr)
            out["metrics"] = tr.metrics.to_json()
        return out
    got = same(go)
    rep = got["report"]
    assert rep["reacted"] == react
    if traced:
        names = {e[1] for e in got["events"]}
        assert "resilience.drift" in names
        assert ("resilience.recover" in names) == react
        assert "slo" in rep


def test_degraded_serve_with_recorder_and_sentinel_matches_reference(
        monkeypatch):
    """The flight recorder as the tracer (snapshotted at the detector's
    fire and the first alerting SLO window), an explicit SLO monitor and a
    drift sentinel built on the nominal System."""
    patch_reference_fetch(monkeypatch)

    def go(s):
        o = s["obs"]
        rec = o.FlightRecorder(capacity=512, clock=lambda: 0.0)
        slo = o.SLOMonitor()
        sent = o.DriftSentinel(s["sys"].get_system("tpu_v5e"))
        rep = _serve(s, "headline", True, slo=slo, sentinel=sent,
                     recorder=rec)
        return {"report": rep.to_json(), "snapshots": rec.snapshots,
                "ring": _events(rec), "dropped": rec.dropped,
                "flagged": sent.flagged_routes(),
                "drifting": sent.drifting_routes()}
    got = same(go)
    assert got["report"]["drift_routes"] and got["flagged"]
    assert got["report"]["slo"]
    reasons = [sn["metadata"]["reason"] for sn in got["snapshots"]]
    assert any(r.startswith("detector_fire") for r in reasons)


def test_recorder_dump_matches_reference(monkeypatch, tmp_path):
    patch_reference_fetch(monkeypatch)

    def go(s):
        rec = s["obs"].FlightRecorder(capacity=256, clock=lambda: 0.0)
        _serve(s, "headline", True, recorder=rec)
        return rec.dump(str(tmp_path / f"{s['deg'].__name__}.json"))
    got = same(go)
    assert got["metadata"]["reason"].startswith(
        ("detector_fire", "slo_violation"))


def test_recalibrate_and_calibration_profile_raise():
    """The refusals: recalibrating needs a sentinel and a profile (the
    reference's own message, tests/test_recal.py), and a profile fitted on
    another preset has no route on this one. The calibrated serves
    themselves are held against the reference in
    tests/test_torch_calibrate.py."""
    import importlib
    from repro_torch.obs import DriftSentinel
    from repro_torch.fabric.systems import get_system
    from repro_torch.runtime.degrade import run_degraded_serve
    sched = _scenario(_sides()[1], "headline")
    with pytest.raises(ValueError, match="recalibrate=True needs"):
        run_degraded_serve(sched, react=True, recalibrate=True,
                           device="cpu")
    sent = DriftSentinel(get_system("tpu_v5e"))
    with pytest.raises(ValueError, match="recalibrate=True needs"):
        run_degraded_serve(sched, recalibrate=True, sentinel=sent,
                           device="cpu")

    def wrong_preset(s, recalibrate):
        pkg = s["deg"].__name__.split(".")[0]
        cal = importlib.import_module(f"{pkg}.calibrate")
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        sent = s["obs"].DriftSentinel(s["sys"].get_system("tpu_v5e"))
        s["deg"].run_degraded_serve(
            _scenario(s, "headline"), recalibrate=recalibrate,
            sentinel=sent, calibration_profile=cal.CalibrationRunner(
                "cxl_pool").calibrate(), **kw)

    for recalibrate in (False, True):
        assert "has no route in preset 'tpu_v5e'" in raises_same(
            lambda s: wrong_preset(s, recalibrate))[1]


def test_degraded_serve_refuses_a_machine_without_cuda(monkeypatch):
    from repro_torch.runtime.degrade import run_degraded_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        run_degraded_serve(_scenario(_sides()[1], "headline"))


# ---------------------------------------------------------------------------
# tests/test_resilience.py's assertions, on the port (no stand-in needed)
# ---------------------------------------------------------------------------


def _port(scenario, react, **kw):
    return _serve(_sides()[1], scenario, react, **kw)


def test_port_degraded_serve_headline_recovers():
    react = _port("headline", True)
    base = _port("headline", False)
    assert react.detect_round is not None
    assert react.detect_latency_rounds <= 3
    assert react.recovery_frac >= 0.8
    assert react.violations_total < base.violations_total
    assert base.recover_round is None
    assert base.recovery_frac < 0.8
    json.dumps(react.to_json())


def test_port_degraded_serve_hot_removal_evacuates():
    react = _port("hot_remove", True)
    base = _port("hot_remove", False)
    assert react.detect_round == 3
    assert react.recovery_frac >= 0.8
    act = next(r.action for r in react.rounds if r.action)
    assert act["weights"] == (1, 0)
    assert base.during_min_tput == 0.0
    assert base.violations_total > react.violations_total


def test_port_degraded_serve_co_tenant():
    react = _port("co_tenant", True)
    assert react.recovery_frac >= 0.8
    assert react.violations_total == 0


def test_port_degraded_serve_emits_resilience_obs():
    from repro_torch.obs import Tracer
    tr = Tracer()
    _port("headline", True, tracer=tr)
    names = {e.name for e in tr.events}
    assert {"resilience.detect", "resilience.recover",
            "resilience.drift"} <= names
    gauges = tr.metrics.to_json()["gauges"]
    assert gauges["resilience.detect_round"] == 3
    assert "resilience.recovery_frac" in gauges


def _filled_cache(weights=(1, 1)):
    from repro_torch.serving.pager import PagedKVCache, PagerConfig
    cache = PagedKVCache(PagerConfig(page_size=8, n_pages=16, kv_heads=2,
                                     head_dim=4, weights=weights),
                         device="cpu")
    cache.allocate(0)
    kv = torch.arange(64 * 2 * 4, dtype=torch.bfloat16).reshape(64, 2, 4)
    cache.append(0, kv, kv)
    return cache


def test_port_retier_preserves_values_through_migration():
    cache = _filled_cache(weights=(1, 1))
    cache.spill_cold_pages()
    before = cache.k_pool.clone()
    info = cache.retier([1, 0])
    assert info["migrated"] and info["to_fast"] > 0
    assert not cache._host_mask.any()
    assert cache.host_pages([0]) == []
    assert torch.equal(cache.k_pool, before)
    assert cache.cfg.weights == (1, 0)


def test_port_recovery_controller_evacuates_real_pages():
    """react() on a hot-removed spill tier: every spilled page comes back
    next to the HBM pool bit for bit, and the action's bytes are the
    moved pages' host bytes (its time simulated on the pre-removal
    fabric)."""
    from repro_torch.fabric.systems import get_system
    from repro_torch.obs import Tracer
    from repro_torch.runtime.degrade import (DegradationSchedule,
                                             RecoveryController,
                                             tier_removed)
    cache = _filled_cache(weights=(2, 1))
    n = cache.spill_cold_pages()
    live = (cache.k_pool.clone(), cache.v_pool.clone())
    cache.k_pool[cache.tier_of_page == 1] = 0     # only the shadow holds them
    cache.v_pool[cache.tier_of_page == 1] = 0
    base = get_system("tpu_v5e")
    gone = DegradationSchedule((tier_removed(0, "host"),)
                               ).degraded_system(base, 0)
    tr = Tracer()
    act = RecoveryController(cache, tracer=tr).react(
        gone, 0, 0.0, migration_system=base)
    assert act.weights == (1, 0) and act.migrated_pages == n > 0
    assert act.migration_bytes == n * cache.host_page_bytes
    assert act.migration_s > 0
    assert torch.equal(cache.k_pool, live[0])
    assert torch.equal(cache.v_pool, live[1])
    assert cache.host_pages([0]) == []
    m = tr.metrics.to_json()
    assert m["gauges"]["resilience.recover_round"] == 0
