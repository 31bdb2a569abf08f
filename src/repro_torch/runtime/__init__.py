"""Runtime layer: fault tolerance, elastic replanning, and the
degradation reaction loop that ties them to the fabric.

``fault`` watches (StepSupervisor, StragglerStats, retry_with_checkpoint),
``elastic`` decides (plan_mesh / replan for training meshes,
replan_interleave for serving placement), and ``degrade`` closes the
sense->decide->act loop over a live serve: inject fabric faults, detect
them from fetch-ETA drift and straggler tails, recover by re-tiering the
KV cache and re-classing the DMA traffic. The reference's
``make_elastic_mesh`` comes with the slice that ports the mesh.
"""

from repro_torch.runtime.degrade import (DegradationDetector,
                                         DegradationEvent,
                                         DegradationSchedule,
                                         DegradedServeConfig,
                                         DegradedServeReport,
                                         DetectorConfig, RecoveryAction,
                                         RecoveryController, co_tenant,
                                         host_link_degraded, link_degrade,
                                         run_degraded_serve, tier_removed)
from repro_torch.runtime.elastic import (ElasticDecision,
                                         degraded_tier_bandwidths,
                                         plan_mesh, replan,
                                         replan_interleave)
from repro_torch.runtime.fault import (HostFailure, StepSupervisor,
                                       StepTimeout, StragglerStats,
                                       retry_with_checkpoint)

__all__ = [
    "DegradationDetector", "DegradationEvent", "DegradationSchedule",
    "DegradedServeConfig", "DegradedServeReport", "DetectorConfig",
    "RecoveryAction", "RecoveryController", "co_tenant",
    "host_link_degraded", "link_degrade", "run_degraded_serve",
    "tier_removed",
    "ElasticDecision", "degraded_tier_bandwidths",
    "plan_mesh", "replan", "replan_interleave",
    "HostFailure", "StepSupervisor", "StepTimeout", "StragglerStats",
    "retry_with_checkpoint",
]
