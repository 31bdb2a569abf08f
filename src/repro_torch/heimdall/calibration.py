"""calibration benchmark family — measure->fit->validate accountability.

The port of the reference's ``repro/heimdall/calibration.py``: the same
rows and ``calibration_summary()``. The reference's wall-clock JAX probe
(``calibration_jax_probe``) becomes ``calibration_torch_probe``: copies
timed with CUDA events on the card.

The paper's loop is measure-then-explain: HEIMDALL profiles the machine and
the architectural model must reproduce the measurements. This family runs
that loop end-to-end over the Table 1 presets against the deterministic
ground-truth machine (``repro_torch.calibrate.runner``: hidden per-link-type
efficiencies + timing noise) and reports how well the fitted model holds up:

  * ``calibration_fit_quality``   — per fitted route: efficiency vs the
                                    hidden truth, fit residual, samples
                                    down-weighted by the noise guard
  * ``calibration_recovery``      — per system: max bandwidth/latency
                                    recovery error vs the truth constants
                                    (the synthetic-truth acceptance number)
  * ``calibration_validation``    — Cohet-style: replay interference + qos
                                    scenarios through fabric.sim on the
                                    calibrated constants; predicted-vs-
                                    measured relative error next to the
                                    nominal preset's error
  * ``calibration_roundtrip``     — TierTopology.from_calibration vs
                                    from_fabric(from_profile) agreement on
                                    derived link constants
  * ``calibration_torch_probe``   — real fit of the card's hbm/host pair
                                    from copies timed with CUDA events
                                    (provenance rows, no thresholds; on
                                    ``device="cpu"`` both tiers share RAM)

``calibration_summary()`` condenses the family into ``BENCH_calibration.
json``; CI asserts the fit-recovery and sim-validation thresholds.
"""

from __future__ import annotations

import functools

from repro_torch.heimdall.harness import Row

GiB = 1 << 30

# Presets exercised by the headline loop (every preset with at least two
# tiers and a registered replay-scenario set).
CAL_SYSTEMS = ("tpu_v5e", "dual_socket_cxl", "cxl_pool", "gh200")

# The hidden machine the fitter must recover: per-link-type efficiencies in
# the band the paper measures (ASIC-CXL delivering ~78% of x8 spec, DDR
# near datasheet, PCIe in the low 80s), datasheet latencies 25% optimistic,
# 2% multiplicative timing noise.
TRUTH_KW = dict(
    efficiency={"pcie": 0.82, "cxl": 0.78, "ddr": 0.92, "hbm": 0.90,
                "nvlink_c2c": 0.84, "upi": 0.88},
    default_efficiency=0.85, latency_scale=1.25, noise=0.02, seed=0)

# CI acceptance thresholds (see calibration_summary / ci.yml).
FIT_BW_ERR_MAX = 0.05            # fitted vs truth bandwidth, any route
FIT_RESIDUAL_MAX = 0.05          # weighted relative RMS residual, any route
VALIDATION_ERR_MAX = 0.05        # calibrated sim vs measured, any scenario
ERROR_REDUCTION_MIN = 3.0        # nominal err / calibrated err, per system


@functools.lru_cache(maxsize=1)
def _calibrated() -> dict:
    """Run the measure->fit->validate loop once per preset (shared by all
    rows and the JSON summary)."""
    from repro_torch.calibrate import (CalibrationRunner, TruthConfig,
                                 validate_samples, validate_scenarios)
    out = {}
    truth = TruthConfig(**TRUTH_KW)
    for name in CAL_SYSTEMS:
        runner = CalibrationRunner(name, source="emulated", truth=truth)
        profile = runner.calibrate()
        out[name] = {
            "runner": runner,
            "profile": profile,
            "report": validate_scenarios(profile, runner.truth_system),
            "samples": validate_samples(profile),
        }
    return out


def _truth_route(runner, est) -> tuple:
    fab = runner.truth_system.fabric
    return (fab.route_bandwidth(est.src, est.dst),
            fab.route_latency(est.src, est.dst))


def calibration_fit_quality() -> list:
    """Per fitted route: efficiency, residual, noise-guard activity."""
    rows = []
    for name, d in _calibrated().items():
        for est in d["profile"].links:
            tb, _ = _truth_route(d["runner"], est)
            rows.append(Row(
                f"calibration_fit/{name}/{est.src}", 0.0,
                f"type={est.link_type};eff={est.efficiency:.3f};"
                f"bw_err={abs(est.bandwidth - tb) / tb:.4f};"
                f"resid={est.rel_residual:.4f};"
                f"downweighted={est.n_downweighted}/{est.n_samples}"))
    return rows


def calibration_recovery() -> list:
    """Synthetic-truth recovery: worst-route constant errors per system."""
    rows = []
    for name, d in _calibrated().items():
        bw_errs, lat_errs = [], []
        for est in d["profile"].links:
            tb, tl = _truth_route(d["runner"], est)
            bw_errs.append(abs(est.bandwidth - tb) / tb)
            lat_errs.append(abs(est.latency - tl) / max(tl, 1e-18))
        rows.append(Row(
            f"calibration_recovery/{name}", 0.0,
            f"bw_err_max={max(bw_errs):.4f};"
            f"lat_err_max={max(lat_errs):.4f};"
            f"routes={len(bw_errs)}"))
    return rows


def calibration_validation() -> list:
    """Per-scenario predicted-vs-measured error, calibrated vs nominal."""
    rows = []
    for name, d in _calibrated().items():
        rep = d["report"]
        for sc in rep.scenarios:
            rows.append(Row(
                f"calibration_validate/{name}/{sc.name}", 0.0,
                f"rel_err={sc.max_rel_err:.4f};"
                f"nominal_rel_err={sc.nominal_max_rel_err:.4f}"))
        rows.append(Row(
            f"calibration_validate/{name}/TOTAL", 0.0,
            f"max_rel_err={rep.max_rel_err:.4f};"
            f"error_reduction={rep.error_reduction:.1f}x;"
            f"sample_replay_max={d['samples']['max_rel_err']:.4f}"))
    return rows


def calibration_roundtrip() -> list:
    """from_calibration vs from_fabric(from_profile) link agreement."""
    from repro_torch.core.tiers import TierTopology
    from repro_torch.fabric.systems import from_profile
    rows = []
    for name, d in _calibrated().items():
        profile = d["profile"]
        t_cal = TierTopology.from_calibration(profile.tier_measurements())
        t_fab = TierTopology.from_fabric(from_profile(profile))
        errs = []
        for (a, b) in t_cal.links:
            bw_d = abs(t_cal.link_bw(a, b) - t_fab.link_bw(a, b)) \
                / t_fab.link_bw(a, b)
            lat_d = abs(t_cal.link_latency(a, b)
                        - t_fab.link_latency(a, b)) \
                / max(t_fab.link_latency(a, b), 1e-18)
            # hub-model bound vs real route: shortcut links (direct
            # host->pool hop) are legitimately faster through the fabric
            errs.append((f"{a}-{b}", bw_d, lat_d))
        worst = max(errs, key=lambda e: max(e[1], e[2]))
        rows.append(Row(
            f"calibration_roundtrip/{name}", 0.0,
            f"links={len(errs)};worst={worst[0]};"
            f"bw_diff={worst[1]:.4f};lat_diff={worst[2]:.4f}"))
    return rows


def calibration_torch_probe(device=None) -> list:
    """Real fit of the card's hbm/host routes from copies timed with CUDA
    events (provenance rows); the tiers the card does not have stay
    emulated. ``device`` defaults to ``cuda``; on ``device="cpu"`` both
    tiers live in RAM, so the fitted constants describe host copies, not
    a link."""
    from repro_torch.calibrate import CalibrationRunner
    KiB, MiB = 1 << 10, 1 << 20
    runner = CalibrationRunner(
        "tpu_v5e", source="auto",
        sizes=(256 * KiB, 1 * MiB, 4 * MiB, 16 * MiB),
        repeats=2, iters=5, device=device)
    profile = runner.calibrate()
    rows = []
    for est in profile.links:
        src = [s for s in profile.samples
               if (s.src, s.dst) == (est.src, est.dst)]
        measured = any(s.source == "torch" for s in src)
        rows.append(Row(
            f"calibration_torch/{est.src}", 0.0,
            f"source={'torch' if measured else 'emulated'};"
            f"GiB_s={est.bandwidth / GiB:.2f};"
            f"lat_us={est.latency * 1e6:.1f};"
            f"resid={est.rel_residual:.3f};"
            f"downweighted={est.n_downweighted}/{est.n_samples}"))
    return rows


ALL_CALIBRATION = [calibration_fit_quality, calibration_recovery,
                   calibration_validation, calibration_roundtrip,
                   calibration_torch_probe]


def calibration_summary() -> dict:
    """The BENCH_calibration.json payload: fit quality + sim validation
    error per preset, with the thresholds CI enforces."""
    from repro_torch.calibrate import PROFILE_VERSION
    data = _calibrated()
    systems = {}
    for name, d in data.items():
        profile, rep = d["profile"], d["report"]
        bw_errs, lat_errs = [], []
        for est in profile.links:
            tb, tl = _truth_route(d["runner"], est)
            bw_errs.append(abs(est.bandwidth - tb) / tb)
            lat_errs.append(abs(est.latency - tl) / max(tl, 1e-18))
        systems[name] = {
            "routes_fitted": len(profile.links),
            "n_samples": len(profile.samples),
            "fit_bw_err_max": max(bw_errs),
            "fit_lat_err_max": max(lat_errs),
            "fit_residual_max": max(e.rel_residual
                                    for e in profile.links),
            "validation_rel_err_max": rep.max_rel_err,
            "validation_rel_err_mean": rep.mean_rel_err,
            "nominal_rel_err_max": rep.nominal_max_rel_err,
            "error_reduction": round(rep.error_reduction, 2),
            "sample_replay_err_max": d["samples"]["max_rel_err"],
            "scenarios": {sc.name: {"rel_err": sc.max_rel_err,
                                    "nominal_rel_err":
                                        sc.nominal_max_rel_err}
                          for sc in rep.scenarios},
        }
    return {
        "family": "calibration",
        "profile_version": PROFILE_VERSION,
        "truth": {k: v for k, v in TRUTH_KW.items()},
        "systems": systems,
        "fit_bw_err_max": max(s["fit_bw_err_max"]
                              for s in systems.values()),
        "fit_residual_max": max(s["fit_residual_max"]
                                for s in systems.values()),
        "validation_rel_err_max": max(s["validation_rel_err_max"]
                                      for s in systems.values()),
        "error_reduction_min": min(s["error_reduction"]
                                   for s in systems.values()),
        "thresholds": {
            "fit_bw_err_max": FIT_BW_ERR_MAX,
            "fit_residual_max": FIT_RESIDUAL_MAX,
            "validation_rel_err_max": VALIDATION_ERR_MAX,
            "error_reduction_min": ERROR_REDUCTION_MIN,
        },
    }
