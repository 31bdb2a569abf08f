"""Fabric presets mirroring the paper's Table 1 machines.

The port's copy of the reference's ``repro/fabric/systems.py``, with
calibrated systems (``from_profile``): a preset whose link constants were
rescaled from a ``CalibrationProfile``, such as one fitted from copies timed
on the card.

Each preset is a ``System``: a fabric graph plus the reference compute node
and a tier-name map, so the cost model / placement engine / benchmarks can
run against any of the paper's platforms by name:

  * ``dual_socket_cxl`` — 2-socket Xeon, local+remote DDR5, ASIC-CXL
    expander (paper's primary CXL testbed; Fig 4-7 numbers)
  * ``cxl_pool``        — multi-host CXL pool behind a switch (Pool/SHM-CXL;
    the shared switch->pool link is the contention point)
  * ``gh200``           — Grace-Hopper: HBM3 + LPDDR5X across NVLink-C2C
  * ``mi300a``          — MI300A APU: CPU+GPU chiplets share HBM3 over
    Infinity Fabric (xGMI)
  * ``tpu_v5e``         — TPU v5e host: HBM / pinned host DRAM over PCIe /
    peer HBM over ICI / pooled DRAM over DCN (mirrors
    ``core.tiers.TierTopology.tpu_v5e`` per-chip numbers)

Bandwidths are per reference compute endpoint (per chip for the TPU preset),
latencies are unloaded one-way; both follow the paper's measured figures
(Fig 4 latency ladder, Fig 5 bandwidth) or public specs where the paper
gives none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.fabric.topology import FabricLink, FabricTopology, LinkType

GiB = 1 << 30


@dataclasses.dataclass(frozen=True)
class System:
    """A fabric plus the bindings consumers need to use it.

    ``tier_map`` maps tier names (the vocabulary of core.tiers / placement)
    to fabric memory nodes. ``kv_tiers`` names the (fast, spill) pair the KV
    pager interleaves across — None for unified-memory machines (MI300A)
    where there is nothing to spill to.
    """
    name: str
    fabric: FabricTopology
    compute: str                          # reference compute node
    tier_map: dict
    kv_tiers: Optional[tuple] = None      # (fast_tier, spill_tier)
    description: str = ""
    # where the link constants came from: "nominal" datasheet presets or a
    # "calibrated" fit (from_profile) — transport.Route carries this so
    # every cost/ETA downstream can say what it rests on
    provenance: str = "nominal"

    def tier_node(self, tier_or_node: str) -> str:
        """Resolve a tier name (or raw node name) to a fabric node."""
        if tier_or_node in self.tier_map:
            return self.tier_map[tier_or_node]
        if tier_or_node in self.fabric.nodes:
            return tier_or_node
        raise ValueError(
            f"{self.name}: unknown tier/node {tier_or_node!r}; tiers="
            f"{sorted(self.tier_map)} nodes={sorted(self.fabric.nodes)}")

    def resolve_flows(self, flows) -> list:
        """Rewrite flows' tier-named endpoints to fabric node names (the
        form contention/sim functions want)."""
        return [dataclasses.replace(f, src=self.tier_node(f.src),
                                    dst=self.tier_node(f.dst))
                for f in flows]

    # Routing in tier vocabulary — lets costmodel.transfer_time accept a
    # System anywhere it accepts a TierTopology.
    def route(self, src: str, dst: str) -> list[FabricLink]:
        return self.fabric.route(self.tier_node(src), self.tier_node(dst))

    def route_bandwidth(self, src: str, dst: str) -> float:
        return self.fabric.route_bandwidth(self.tier_node(src),
                                           self.tier_node(dst))

    def route_latency(self, src: str, dst: str) -> float:
        return self.fabric.route_latency(self.tier_node(src),
                                         self.tier_node(dst))

    def compute_nodes(self) -> list[str]:
        """All compute-kind node names, sorted (``compute`` is the
        reference; the rest are candidates for disaggregated roles)."""
        from repro_torch.fabric.topology import NodeKind
        return sorted(n.name for n in self.fabric.nodes.values()
                      if n.kind is NodeKind.COMPUTE)


# --------------------------------------------------------------------------
# Presets
# --------------------------------------------------------------------------


def dual_socket_cxl() -> System:
    """2-socket server + ASIC CXL expander (paper's main testbed)."""
    f = FabricTopology("dual_socket_cxl")
    f.add_node("socket0", "compute")
    f.add_node("socket1", "compute")
    f.add_node("dram0", "memory", capacity=256 * GiB)
    f.add_node("dram1", "memory", capacity=256 * GiB)
    f.add_node("cxl_exp", "memory", capacity=128 * GiB)
    # Fig 5: ~208 GiB/s local DDR5; Fig 4: ~110 ns local, ~250 ns remote.
    f.add_link("socket0", "dram0", LinkType.DDR, 220e9, 110e-9)
    f.add_link("socket1", "dram1", LinkType.DDR, 220e9, 110e-9)
    f.add_link("socket0", "socket1", LinkType.UPI, 62e9, 140e-9)
    # ASIC-CXL x8: ~26 GB/s read, 200-300 ns added latency (Fig 4/5).
    f.add_link("socket0", "cxl_exp", LinkType.CXL, 26e9, 300e-9)
    return System(
        name="dual_socket_cxl", fabric=f, compute="socket0",
        tier_map={"local_dram": "dram0", "remote_dram": "dram1",
                  "cxl": "cxl_exp"},
        kv_tiers=("local_dram", "cxl"),
        description="2-socket Xeon + ASIC CXL expander")


def cxl_pool(n_hosts: int = 3) -> System:
    """Multi-host CXL pool behind a switch (Pool/SHM-CXL).

    Every host reaches the pooled DRAM through the same switch->pool link —
    the shared resource the noisy-neighbor scenario contends on.
    """
    f = FabricTopology("cxl_pool")
    f.add_node("pool_switch", "switch")
    f.add_node("pool_mem", "memory", capacity=512 * GiB)
    # Switch->pool: x16-class (~52 GB/s); per-host x8 links into the switch.
    f.add_link("pool_switch", "pool_mem", LinkType.CXL, 52e9, 400e-9)
    for i in range(max(1, n_hosts)):
        f.add_node(f"host{i}", "compute")
        f.add_node(f"dram{i}", "memory", capacity=256 * GiB)
        f.add_link(f"host{i}", f"dram{i}", LinkType.DDR, 220e9, 110e-9)
        # Fig 4: Pool-CXL total latency >500 ns (150 + 400 here).
        f.add_link(f"host{i}", "pool_switch", LinkType.CXL, 26e9, 150e-9)
    return System(
        name="cxl_pool", fabric=f, compute="host0",
        tier_map={"local_dram": "dram0", "pool": "pool_mem"},
        kv_tiers=("local_dram", "pool"),
        description=f"{n_hosts}-host CXL pool behind a shared switch")


def gh200() -> System:
    """NVIDIA GH200: Hopper HBM3 + Grace LPDDR5X across NVLink-C2C."""
    f = FabricTopology("gh200")
    f.add_node("hopper", "compute")
    f.add_node("grace", "compute")
    f.add_node("hbm3", "memory", capacity=96 * GiB)
    f.add_node("lpddr", "memory", capacity=480 * GiB)
    f.add_link("hopper", "hbm3", LinkType.HBM, 4000e9, 350e-9)
    f.add_link("grace", "lpddr", LinkType.DDR, 500e9, 120e-9)
    # NVLink-C2C: 900 GB/s bidirectional -> 450 GB/s per direction.
    f.add_link("hopper", "grace", LinkType.NVLINK_C2C, 450e9, 500e-9)
    return System(
        name="gh200", fabric=f, compute="hopper",
        tier_map={"hbm": "hbm3", "host": "lpddr"},
        kv_tiers=("hbm", "host"),
        description="Grace-Hopper superchip, NVLink-C2C coherent link")


def mi300a() -> System:
    """AMD MI300A APU: CPU and GPU chiplets share unified HBM3 over
    Infinity Fabric. Unified memory — no spill tier, but CPU and GPU
    traffic contend on their xGMI paths into the same stacks."""
    f = FabricTopology("mi300a")
    f.add_node("xcd", "compute")      # GPU chiplets (aggregate)
    f.add_node("ccd", "compute")      # CPU chiplets (aggregate)
    f.add_node("hbm3_unified", "memory", capacity=128 * GiB)
    f.add_link("xcd", "hbm3_unified", LinkType.XGMI, 5300e9, 400e-9)
    f.add_link("ccd", "hbm3_unified", LinkType.XGMI, 800e9, 250e-9)
    f.add_link("xcd", "ccd", LinkType.XGMI, 430e9, 300e-9)
    return System(
        name="mi300a", fabric=f, compute="xcd",
        tier_map={"hbm": "hbm3_unified"},
        kv_tiers=None,
        description="MI300A unified-memory APU over Infinity Fabric")


def tpu_v5e(chips_per_host: int = 4) -> System:
    """TPU v5e host — the repo's native platform, same per-chip numbers as
    ``TierTopology.tpu_v5e`` but as a routed graph (chip0 is the reference;
    peer HBM is reached *through* chip1 over ICI, the pool through host
    DRAM over DCN)."""
    pcie_per_chip = 32e9 / chips_per_host
    dcn_per_chip = 25e9 / chips_per_host
    host_share = (512 * 2**30) // chips_per_host
    f = FabricTopology("tpu_v5e")
    f.add_node("chip0", "compute")
    f.add_node("chip1", "compute")
    f.add_node("hbm0", "memory", capacity=16 * 2**30,
               memory_kind="device")
    f.add_node("hbm1", "memory", capacity=16 * 2**30)
    f.add_node("host_dram", "memory", capacity=host_share,
               memory_kind="pinned_host")
    f.add_node("pool_mem", "memory", capacity=4 * host_share)
    f.add_link("chip0", "hbm0", LinkType.HBM, 819e9, 0.4e-6)
    f.add_link("chip1", "hbm1", LinkType.HBM, 819e9, 0.4e-6)
    f.add_link("chip0", "chip1", LinkType.ICI, 50e9, 1e-6)
    f.add_link("chip0", "host_dram", LinkType.PCIE, pcie_per_chip, 2e-6)
    f.add_link("chip1", "host_dram", LinkType.PCIE, pcie_per_chip, 2e-6)
    f.add_link("host_dram", "pool_mem", LinkType.DCN, dcn_per_chip, 10e-6)
    return System(
        name="tpu_v5e", fabric=f, compute="chip0",
        tier_map={"hbm": "hbm0", "host": "host_dram", "pool": "pool_mem",
                  "peer_hbm": "hbm1"},
        kv_tiers=("hbm", "host"),
        description="TPU v5e host: HBM/PCIe host/ICI peer/DCN pool")


SYSTEMS: dict[str, Callable[[], System]] = {
    "dual_socket_cxl": dual_socket_cxl,
    "cxl_pool": cxl_pool,
    "gh200": gh200,
    "mi300a": mi300a,
    "tpu_v5e": tpu_v5e,
}


def get_system(name: str) -> System:
    """Build a fresh preset by name (see ``SYSTEMS``)."""
    try:
        factory = SYSTEMS[name]
    except KeyError:
        raise ValueError(f"unknown system {name!r}; available: "
                         f"{sorted(SYSTEMS)}") from None
    system = factory()
    system.fabric.validate()
    return system


def from_profile(profile, preset: Optional[str] = None) -> System:
    """Calibrated system: the preset's links rescaled from measurements.

    ``profile`` is a ``repro_torch.calibrate.CalibrationProfile`` (one
    written by either package); ``preset`` defaults to the system the
    profile was measured on. Each fitted route estimate rescales the
    preset graph:

      * the route's *bottleneck* link takes the fitted bandwidth (that is
        the only link the bandwidth measurement can see);
      * every link on the route scales its latency by the route's fitted
        latency ratio (hop latencies are not separable from an end-to-end
        probe, so the ratio is distributed).

    Links measured by several routes take the median proposed scale.
    Unmeasured links of a *measured link type* take that type's median
    scale — the two PCIe lanes of a host are the same silicon, and leaving
    a sibling link at nominal would let shortest-path routing escape the
    calibration through it. Types never measured keep nominal constants.
    The result is a ``System`` like any preset — ``TierTopology.
    from_fabric`` derives calibrated tier constants from it, so costmodel /
    placement / pager plan on fitted numbers with no further wiring.
    """
    import statistics

    base = get_system(preset or profile.system)
    bw_scales: dict = {}
    lat_scales: dict = {}
    type_bw: dict = {}
    type_lat: dict = {}
    for est in profile.links:
        try:
            route = base.fabric.route(est.src, est.dst)
        except ValueError:
            raise ValueError(
                f"profile estimate {est.src}->{est.dst} has no route in "
                f"preset {base.name!r}; the profile was measured on "
                f"{profile.system!r} — pass a compatible preset") from None
        if not route:
            continue
        bott = min(route, key=lambda l: l.bandwidth)
        key = (min(bott.src, bott.dst), max(bott.src, bott.dst))
        bw_ratio = est.bandwidth / bott.bandwidth
        bw_scales.setdefault(key, []).append(bw_ratio)
        type_bw.setdefault(bott.type, []).append(bw_ratio)
        nominal_lat = sum(l.latency for l in route)
        ratio = est.latency / nominal_lat if nominal_lat > 0 else 1.0
        for link in route:
            k = (min(link.src, link.dst), max(link.src, link.dst))
            lat_scales.setdefault(k, []).append(ratio)
            type_lat.setdefault(link.type, []).append(ratio)
    scales = {}
    seen: set = set()
    for (a, b), link in base.fabric.links.items():
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        bw = (statistics.median(bw_scales[key]) if key in bw_scales
              else statistics.median(type_bw[link.type])
              if link.type in type_bw else 1.0)
        lat = (statistics.median(lat_scales[key]) if key in lat_scales
               else statistics.median(type_lat[link.type])
               if link.type in type_lat else 1.0)
        scales[key] = (bw, lat)
    fab = base.fabric.rescaled(scales, name=f"{base.name}+calibrated")
    return dataclasses.replace(
        base, fabric=fab, provenance="calibrated",
        description=f"{base.description} (calibrated from "
                    f"{len(profile.links)} fitted routes, "
                    f"source={profile.source})")
