"""Contention-aware interconnect fabric simulator.

The port's copy of the reference's ``repro/fabric``.

Layers (bottom-up):
  topology   — device/memory/switch graph, typed links, latency routing
  systems    — presets for the paper's machines (Table 1)
  contention — QoS-aware max-min sharing (strict priority between classes,
               weighted within one) + multi-flow loaded latency
  sim        — discrete-event fluid-flow transfer engine

Consumers: core.costmodel routes transfer_time through here, core.placement
picks interleave weights from contended bandwidths, serving.pager schedules
prefetches via sim, heimdall.interference benchmarks the scenarios.
"""

from repro_torch.fabric.contention import (Flow, effective_bandwidth,
                                           loaded_latency_multi,
                                           max_min_rates,
                                           route_loaded_latency)
from repro_torch.fabric.scenarios import (ALL_SCENARIOS, ScenarioResult,
                                          bidirectional_fight,
                                          noisy_neighbor_pool,
                                          offload_vs_prefetch,
                                          qos_prefetch_over_bulk,
                                          run_scenario)
from repro_torch.fabric.sim import FlowResult, makespan, simulate, \
    single_flow_time
from repro_torch.fabric.systems import SYSTEMS, System, cxl_pool, \
    dual_socket_cxl, from_profile, get_system, gh200, mi300a, tpu_v5e
from repro_torch.fabric.topology import (FabricLink, FabricNode,
                                         FabricTopology, LinkType, NodeKind)

__all__ = [
    "FabricLink", "FabricNode", "FabricTopology", "LinkType", "NodeKind",
    "SYSTEMS", "System", "get_system", "from_profile", "dual_socket_cxl",
    "cxl_pool", "gh200", "mi300a", "tpu_v5e",
    "Flow", "max_min_rates", "effective_bandwidth", "loaded_latency_multi",
    "route_loaded_latency",
    "FlowResult", "simulate", "makespan", "single_flow_time",
    "ScenarioResult", "run_scenario", "ALL_SCENARIOS",
    "noisy_neighbor_pool", "offload_vs_prefetch", "bidirectional_fight",
    "qos_prefetch_over_bulk",
]
