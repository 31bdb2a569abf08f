"""repro.transport — the one vocabulary for moving bytes over the fabric.

The port's copy of the reference's ``repro/transport``.

Every layer that moves (or costs) pages used to re-derive routes, QoS
classes, compression factors, and ETAs on its own: ``costmodel.
transfer_time``/``contended_transfer_time``, the pager's two
``plan_prefetch`` implementations, ``placement.contended_tier_bandwidths``,
``elastic.degraded_tier_bandwidths``, and degrade's recovery migration.
This package is the single abstraction they all speak now:

  * ``Route``          — a resolved src->dst path on a ``System`` or raw
                         ``FabricTopology``: bottleneck bandwidth, summed
                         hop latency, and provenance (nominal preset
                         constants vs hardware-calibrated fit).
  * ``PageTransfer``   — one logical payload with its wire size after
                         ``kv_dtype`` compression, DMA QoS class
                         (weight/priority), earliest start, and optional
                         deadline.
  * ``TransferPlan``   — the planner's output: per-transfer ETAs against
                         background traffic, ``ready_by`` deadline queries,
                         deadline ``violations``.
  * ``plan_transfers`` — the one planner: wraps ``fabric.sim.simulate`` /
                         ``effective_bandwidth`` and carries the tracer/
                         metrics surface (``transport.*`` counters).
  * ``probe_tier_bandwidths`` — the one contended tier-bandwidth probe
                         (placement's strict form and elastic's tolerant
                         degraded form are the same loop).

Outside ``repro.fabric`` and this package, nothing calls
``effective_bandwidth`` directly — a guard test enforces the fence.
"""

from repro_torch.transport.plan import (PageTransfer, TransferPlan,
                                       plan_transfers)
from repro_torch.transport.route import (PROVENANCE_CALIBRATED,
                                         PROVENANCE_NOMINAL, Route,
                                         probe_tier_bandwidths)

__all__ = [
    "PROVENANCE_CALIBRATED", "PROVENANCE_NOMINAL",
    "PageTransfer", "Route", "TransferPlan",
    "plan_transfers", "probe_tier_bandwidths",
]
