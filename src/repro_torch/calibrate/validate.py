"""Hold the calibrated simulator accountable to the measurements.

The port's copy of the reference's ``repro/calibrate/validate.py``.

Cohet's discipline: after fitting the model from measurements, replay the
*interference* workloads through the simulator and report predicted-vs-
measured error — a calibration that only matches the uncontended probes it
was fitted on proves nothing about the contention model.

Two validation modes:

  * ``validate_samples``   — per-sample closed-form replay: the calibrated
                             system's ``transfer_time`` vs each measured
                             ``LinkSample.seconds`` (works for any sample
                             source, including the card's timed copies).
  * ``validate_scenarios`` — the full pass: replay the preset's
                             interference and qos scenario flows through
                             ``fabric.sim`` on the calibrated fabric
                             (predicted) and on the ground-truth machine
                             (measured); report per-scenario relative
                             error, next to the *nominal* preset's error so
                             the headline is how much accountability
                             calibration buys back.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional, Sequence

from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.fabric.contention import Flow
from repro_torch.obs.trace import NULL_TRACER

MiB = 1 << 20

# Scenario flows replayable on each preset (tier- or node-named endpoints;
# ``System.resolve_flows`` maps them). These mirror fabric.scenarios /
# heimdall.qos but are parameterized by *which fabric* they run on — the
# point of validation is running identical flows on truth vs model.
REPLAY_SCENARIOS: dict = {
    "tpu_v5e": {
        "interference/offload_vs_prefetch": [
            Flow("offload", "host", "hbm", 512 * MiB),
            Flow("kv_prefetch", "host", "hbm", 64 * MiB),
        ],
        "interference/staggered_pair": [
            Flow("a", "host", "hbm", 128 * MiB),
            Flow("b", "host", "hbm", 128 * MiB, start=5e-3),
        ],
        "qos/prefetch_over_bulk": [
            Flow("offload", "host", "hbm", 512 * MiB),
            Flow("kv_prefetch", "host", "hbm", 64 * MiB, priority=1),
        ],
        "qos/weighted_4to1": [
            Flow("heavy", "host", "hbm", 256 * MiB, weight=4.0),
            Flow("light", "host", "hbm", 256 * MiB),
        ],
    },
    "cxl_pool": {
        "interference/noisy_neighbor_x2": [
            Flow("victim", "pool_mem", "host0", 256 * MiB),
            Flow("neighbor0", "pool_mem", "host1", 256 * MiB),
            Flow("neighbor1", "pool_mem", "host2", 256 * MiB),
        ],
        "qos/shielded_victim": [
            Flow("victim", "pool_mem", "host0", 256 * MiB, priority=1),
            Flow("neighbor0", "pool_mem", "host1", 256 * MiB),
            Flow("neighbor1", "pool_mem", "host2", 256 * MiB),
        ],
    },
    "dual_socket_cxl": {
        "interference/bidirectional_fight": [
            Flow("ddr_read", "dram0", "socket0", 256 * MiB),
            Flow("ddr_write", "socket0", "dram0", 256 * MiB),
            Flow("cxl_read", "cxl_exp", "socket0", 32 * MiB),
            Flow("cxl_write", "socket0", "cxl_exp", 32 * MiB),
        ],
        "qos/prioritized_cxl_read": [
            Flow("cxl_read", "cxl_exp", "socket0", 64 * MiB, priority=1),
            Flow("cxl_bulk", "cxl_exp", "socket0", 256 * MiB),
        ],
    },
    "gh200": {
        "interference/c2c_pair": [
            Flow("weights", "host", "hbm", 1024 * MiB),
            Flow("kv", "host", "hbm", 128 * MiB),
        ],
        "qos/kv_over_weights": [
            Flow("weights", "host", "hbm", 1024 * MiB),
            Flow("kv", "host", "hbm", 128 * MiB, priority=1),
        ],
    },
    "mi300a": {
        "interference/cpu_gpu_hbm": [
            Flow("gpu_read", "hbm", "xcd", 1024 * MiB),
            Flow("cpu_read", "hbm", "ccd", 256 * MiB),
        ],
    },
}


@dataclasses.dataclass(frozen=True)
class FlowError:
    flow_id: str
    predicted: float             # calibrated-sim duration (s)
    measured: float              # truth-machine duration (s)
    nominal: float               # uncalibrated-preset duration (s)

    @property
    def rel_err(self) -> float:
        return abs(self.predicted - self.measured) / self.measured

    @property
    def nominal_rel_err(self) -> float:
        return abs(self.nominal - self.measured) / self.measured


@dataclasses.dataclass(frozen=True)
class ScenarioValidation:
    name: str
    flows: tuple                 # tuple[FlowError]

    @property
    def max_rel_err(self) -> float:
        return max(f.rel_err for f in self.flows)

    @property
    def mean_rel_err(self) -> float:
        return statistics.fmean(f.rel_err for f in self.flows)

    @property
    def nominal_max_rel_err(self) -> float:
        return max(f.nominal_rel_err for f in self.flows)


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    system: str
    scenarios: tuple             # tuple[ScenarioValidation]

    @property
    def max_rel_err(self) -> float:
        return max(s.max_rel_err for s in self.scenarios)

    @property
    def mean_rel_err(self) -> float:
        return statistics.fmean(s.mean_rel_err for s in self.scenarios)

    @property
    def nominal_max_rel_err(self) -> float:
        return max(s.nominal_max_rel_err for s in self.scenarios)

    @property
    def error_reduction(self) -> float:
        """How much scenario error calibration removed vs the nominal
        preset (>1 means the calibrated model explains the measurements
        better than the datasheet constants)."""
        return self.nominal_max_rel_err / max(self.max_rel_err, 1e-12)

    def to_json(self) -> dict:
        return {
            "system": self.system,
            "max_rel_err": self.max_rel_err,
            "mean_rel_err": self.mean_rel_err,
            "nominal_max_rel_err": self.nominal_max_rel_err,
            "error_reduction": round(self.error_reduction, 3),
            "scenarios": {
                s.name: {
                    "max_rel_err": s.max_rel_err,
                    "mean_rel_err": s.mean_rel_err,
                    "nominal_max_rel_err": s.nominal_max_rel_err,
                    "flows": {f.flow_id: {"predicted_s": f.predicted,
                                          "measured_s": f.measured,
                                          "nominal_s": f.nominal,
                                          "rel_err": f.rel_err}
                              for f in s.flows},
                } for s in self.scenarios
            },
        }


def _durations(system, flows: Sequence[Flow],
               tracer=NULL_TRACER) -> dict:
    from repro_torch.fabric.sim import simulate
    res = simulate(system.fabric, system.resolve_flows(flows),
                   tracer=tracer)
    return {r.flow.id: r.duration for r in res}


def validate_scenarios(profile: CalibrationProfile, truth_system, *,
                       preset: Optional[str] = None,
                       scenarios: Optional[dict] = None,
                       tracer=NULL_TRACER) -> ValidationReport:
    """Replay the preset's interference/qos scenarios on truth vs model.

    ``truth_system`` is the machine the measurements came from (for the
    emulated source, ``runner.ground_truth_system``; on real hardware it
    would be the hardware itself and this function's role is played by
    re-measuring). Each scenario's flows run identically on three fabrics:
    the truth (measured), the calibrated model (predicted), and the
    nominal preset (the accountability baseline).

    An enabled ``tracer`` records each replay with its provenance: the
    truth run's fabric tracks land under process ``"truth/fabric"``, the
    calibrated model's under ``"calibrated/fabric"``, the datasheet
    preset's under ``"nominal/fabric"``, and every span/flow event carries
    ``provenance`` and ``scenario`` tags — so a Perfetto view shows the
    same contended flows on all three fabrics, stacked.
    """
    from repro_torch.fabric.systems import from_profile, get_system
    name = preset or profile.system
    scenarios = scenarios if scenarios is not None \
        else REPLAY_SCENARIOS.get(name)
    if not scenarios:
        raise ValueError(f"no replay scenarios registered for {name!r}; "
                         f"have {sorted(REPLAY_SCENARIOS)}")
    calibrated = from_profile(profile, preset=name)
    nominal = get_system(name)
    out = []
    for sc_name, flows in sorted(scenarios.items()):

        def _tr(provenance):
            # scenarios replay at overlapping sim times — distinct track
            # processes per (scenario, provenance) keep timelines separable
            return tracer.scoped(f"{sc_name}/{provenance}",
                                 provenance=provenance, scenario=sc_name)

        pred = _durations(calibrated, flows, _tr("calibrated"))
        meas = _durations(truth_system, flows, _tr("truth"))
        nom = _durations(nominal, flows, _tr("nominal"))
        out.append(ScenarioValidation(
            sc_name,
            tuple(FlowError(fid, pred[fid], meas[fid], nom[fid])
                  for fid in sorted(pred))))
    return ValidationReport(name, tuple(out))


def validate_samples(profile: CalibrationProfile,
                     samples: Optional[Sequence] = None, *,
                     preset: Optional[str] = None) -> dict:
    """Closed-form replay of every measured sample on the calibrated
    system: ``transfer_time(nbytes, calibrated, src, dst)`` vs the sample's
    measured seconds. Returns summary stats (max/mean/p90 relative error).
    Works for any sample source — this is the validation available on real
    hardware where no truth fabric exists."""
    from repro_torch.core.costmodel import transfer_time
    from repro_torch.fabric.systems import from_profile
    samples = samples if samples is not None else profile.samples
    if not samples:
        raise ValueError("no samples to validate against")
    calibrated = from_profile(profile, preset=preset)
    errs = []
    for s in samples:
        pred = transfer_time(s.nbytes, calibrated, s.src, s.dst)
        errs.append(abs(pred - s.seconds) / s.seconds)
    errs.sort()
    return {
        "n_samples": len(errs),
        "max_rel_err": errs[-1],
        "mean_rel_err": statistics.fmean(errs),
        "p90_rel_err": errs[min(len(errs) - 1, int(0.9 * len(errs)))],
    }
