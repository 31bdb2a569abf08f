"""Hardware calibration: fit fabric link constants from measurements.

The port of the reference's ``repro/calibrate/``. Closes the
measure->explain loop between ``repro_torch.heimdall`` (measurement) and
``repro_torch.fabric`` (model):

  runner    — CalibrationRunner: probe each route at several transfer
              sizes (copies timed with CUDA events where the tier is
              addressable on the card, a
              deterministic ground-truth emulation elsewhere), with the
              dispersion-based noise guard (rerun unstable samples)
  fit       — robust weighted least-squares fitter: per-route
              LinkEstimate (bandwidth, latency, efficiency vs nominal)
  profile   — versioned CalibrationProfile JSON artifact (machine
              metadata, sample provenance, tolerant/validating loader)
  validate  — Cohet-style accountability: replay interference/qos
              scenarios through fabric.sim on the calibrated constants
              and report predicted-vs-measured relative error
  recal     — AutoRecalibrator: on a DriftSentinel flag, re-probe only
              the drifted route against the live fabric, robust-refit,
              hot-swap the constants and acknowledge the flag

Calibrated constants flow to every planner through
``fabric.systems.from_profile(profile)`` -> ``TierTopology.from_fabric``:
costmodel, placement, and the KV pager all plan on fitted numbers.
"""

from repro_torch.calibrate.fit import (DEFAULT_MAX_DISPERSION, fit_profile,
                                       fit_route, sample_weight)
from repro_torch.calibrate.profile import (PROFILE_VERSION,
                                           CalibrationProfile, LinkEstimate,
                                           LinkSample, ProfileError,
                                           machine_metadata)
from repro_torch.calibrate.recal import AutoRecalibrator, RecalResult
from repro_torch.calibrate.runner import (CalibrationRunner, TruthConfig,
                                          ground_truth_system)
from repro_torch.calibrate.validate import (REPLAY_SCENARIOS, FlowError,
                                            ScenarioValidation,
                                            ValidationReport,
                                            validate_samples,
                                            validate_scenarios)

__all__ = [
    "CalibrationProfile", "LinkEstimate", "LinkSample", "ProfileError",
    "PROFILE_VERSION", "machine_metadata",
    "fit_profile", "fit_route", "sample_weight", "DEFAULT_MAX_DISPERSION",
    "CalibrationRunner", "TruthConfig", "ground_truth_system",
    "AutoRecalibrator", "RecalResult",
    "validate_scenarios", "validate_samples", "ValidationReport",
    "ScenarioValidation", "FlowError", "REPLAY_SCENARIOS",
]
