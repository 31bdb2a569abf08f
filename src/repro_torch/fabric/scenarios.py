"""Interference scenarios: named experiments over the fabric simulator.

The port's copy of the reference's ``repro/fabric/scenarios.py``.

Each scenario builds a preset system, runs every flow solo (uncontended
reference) and then all flows together, and reports per-flow slowdowns —
the CXL-Interference methodology in miniature. These feed the HEIMDALL
interference benchmark family and the fabric tests.
"""

from __future__ import annotations

import dataclasses

from repro_torch.fabric.contention import Flow
from repro_torch.fabric.sim import FlowResult, simulate
from repro_torch.fabric.systems import System, cxl_pool, dual_socket_cxl, \
    get_system

MiB = 1 << 20


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    name: str
    system: System
    results: list                 # list[FlowResult], contended run
    solo: dict                    # flow id -> uncontended duration (s)
    slowdown: dict                # flow id -> contended / solo duration

    def result(self, flow_id: str) -> FlowResult:
        for r in self.results:
            if r.flow.id == flow_id:
                return r
        raise ValueError(f"no flow {flow_id!r} in scenario {self.name}")


def run_scenario(name: str, system: System,
                 flows: list) -> ScenarioResult:
    solo, slowdown = {}, {}
    for f in flows:
        solo[f.id] = simulate(system.fabric, [f])[0].duration
    results = simulate(system.fabric, flows)
    for r in results:
        slowdown[r.flow.id] = r.duration / solo[r.flow.id]
    return ScenarioResult(name, system, results, solo, slowdown)


def noisy_neighbor_pool(n_neighbors: int = 2,
                        nbytes: int = 256 * MiB) -> ScenarioResult:
    """Victim host reads from the CXL pool while neighbor hosts hammer the
    same pool: everyone funnels through the shared switch->pool link, so the
    victim's bandwidth collapses as neighbors join (the pooled-memory
    noisy-neighbor problem)."""
    system = cxl_pool(n_hosts=1 + n_neighbors)
    flows = [Flow("victim", "pool_mem", "host0", nbytes)]
    flows += [Flow(f"neighbor{i}", "pool_mem", f"host{i + 1}", nbytes)
              for i in range(n_neighbors)]
    return run_scenario(f"noisy_neighbor_pool/x{n_neighbors}", system, flows)


def offload_vs_prefetch(offload_bytes: int = 512 * MiB,
                        prefetch_bytes: int = 64 * MiB) -> ScenarioResult:
    """Weight-offload streaming vs KV-page prefetch on the TPU host: both
    cross the same chip<->host PCIe link, so the small latency-critical
    prefetch gets stretched by the big offload stream (why the serving loop
    must schedule them, not just issue them)."""
    system = get_system("tpu_v5e")
    flows = [Flow("offload", "host_dram", "chip0", offload_bytes),
             Flow("kv_prefetch", "host_dram", "chip0", prefetch_bytes)]
    return run_scenario("offload_vs_prefetch", system, flows)


def qos_prefetch_over_bulk(offload_bytes: int = 512 * MiB,
                           prefetch_bytes: int = 64 * MiB,
                           priority: int = 1,
                           weight: float = 1.0) -> ScenarioResult:
    """The DMA-QoS counterpart of ``offload_vs_prefetch``: the same two
    flows on the same shared PCIe link, but the latency-critical KV
    prefetch is issued in a higher-priority class (or a heavier weight) —
    strict-priority arbitration shields it from the bulk stream (slowdown
    ~1.0) while the offload absorbs the wait it used to inflict."""
    system = get_system("tpu_v5e")
    flows = [Flow("offload", "host_dram", "chip0", offload_bytes),
             Flow("kv_prefetch", "host_dram", "chip0", prefetch_bytes,
                  weight=weight, priority=priority)]
    return run_scenario(f"qos_prefetch_over_bulk/p{priority}w{weight:g}",
                        system, flows)


def bidirectional_fight(nbytes: int = 256 * MiB) -> ScenarioResult:
    """Read+write fight on a half-duplex DDR bus vs peaceful coexistence on
    a full-duplex CXL link (the paper's directionality asymmetry): the DDR
    pair slows ~2x, the CXL pair doesn't."""
    system = dual_socket_cxl()
    flows = [Flow("ddr_read", "dram0", "socket0", nbytes),
             Flow("ddr_write", "socket0", "dram0", nbytes),
             Flow("cxl_read", "cxl_exp", "socket0", nbytes // 8),
             Flow("cxl_write", "socket0", "cxl_exp", nbytes // 8)]
    return run_scenario("bidirectional_fight", system, flows)


ALL_SCENARIOS = {
    "noisy_neighbor_pool": noisy_neighbor_pool,
    "offload_vs_prefetch": offload_vs_prefetch,
    "qos_prefetch_over_bulk": qos_prefetch_over_bulk,
    "bidirectional_fight": bidirectional_fight,
}
