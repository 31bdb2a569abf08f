"""Memory-tier and link topology model.

The port's copy of the reference's ``repro/core/tiers.py``: the paper's
Table 1 / Figure 1 as tiers (capacity, bandwidth, latency) and the links
between them. ``tpu_v5e`` is the reference's default topology, from
published v5e numbers: it describes a TPU host, not the H100 the port runs
on, and the planners budget against it by default. The card's own link
constants come from a calibrated system: ``from_fabric(from_profile(p))``
with a profile ``p`` fitted from copies timed on the card
(``calibrate.CalibrationRunner(source="torch")``). ``from_fabric`` derives
the same model from any fabric preset, ``from_calibration`` from measured
tiers.

Paper tier -> tier here:
    DIMM (local)      -> HBM           (fast, small, 'device')
    CXL expander      -> pinned host   (slower link, big, 'pinned_host')
    CXL pool / SHM    -> pooled host   (DCN-reachable, biggest, highest lat)
    remote-NUMA DIMM  -> peer-chip HBM over ICI
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline import hw


@dataclasses.dataclass(frozen=True)
class MemoryTier:
    name: str
    capacity: int              # bytes available per chip(-share)
    read_bw: float             # bytes/s per chip
    write_bw: float            # bytes/s per chip
    latency: float             # seconds (single cacheline-equivalent access)
    memory_kind: Optional[str]  # 'device' / 'pinned_host', None if not addressable


@dataclasses.dataclass(frozen=True)
class Link:
    src: str
    dst: str
    bandwidth: float           # bytes/s per chip
    latency: float


@dataclasses.dataclass(frozen=True)
class TierTopology:
    tiers: dict
    links: dict

    def tier(self, name: str) -> MemoryTier:
        return self.tiers[name]

    def _link(self, src: str, dst: str) -> Link:
        if (src, dst) in self.links:
            return self.links[(src, dst)]
        if (dst, src) in self.links:
            return self.links[(dst, src)]
        raise KeyError((src, dst))

    def link_bw(self, src: str, dst: str) -> float:
        return self._link(src, dst).bandwidth

    def link_latency(self, src: str, dst: str) -> float:
        return self._link(src, dst).latency

    @classmethod
    def tpu_v5e(cls, chips_per_host: int = hw.CHIPS_PER_HOST
                ) -> "TierTopology":
        pcie_per_chip = hw.PCIE_BANDWIDTH / chips_per_host
        host_share = hw.HOST_DRAM_CAPACITY // chips_per_host
        tiers = {
            "hbm": MemoryTier("hbm", hw.HBM_CAPACITY, hw.HBM_BANDWIDTH,
                              hw.HBM_BANDWIDTH, 0.4e-6, "device"),
            "host": MemoryTier("host", host_share, pcie_per_chip,
                               pcie_per_chip, 2e-6, "pinned_host"),
            "pool": MemoryTier("pool", 4 * host_share,
                               hw.DCN_BANDWIDTH_PER_HOST / chips_per_host,
                               hw.DCN_BANDWIDTH_PER_HOST / chips_per_host,
                               10e-6, None),
            "peer_hbm": MemoryTier("peer_hbm", hw.HBM_CAPACITY,
                                   hw.ICI_LINK_BANDWIDTH,
                                   hw.ICI_LINK_BANDWIDTH, 1e-6, None),
        }
        links = {
            ("hbm", "host"): Link("hbm", "host", pcie_per_chip, 2e-6),
            ("hbm", "peer_hbm"): Link("hbm", "peer_hbm",
                                      hw.ICI_LINK_BANDWIDTH, 1e-6),
            ("hbm", "pool"): Link("hbm", "pool",
                                  hw.DCN_BANDWIDTH_PER_HOST / chips_per_host,
                                  10e-6),
            ("host", "pool"): Link("host", "pool",
                                   hw.DCN_BANDWIDTH_PER_HOST / chips_per_host,
                                   10e-6),
        }
        return cls(tiers=tiers, links=links)

    @classmethod
    def from_calibration(cls, measurements: dict) -> "TierTopology":
        """Build a topology from HEIMDALL measurement output
        ({tier: {capacity, read_bw, write_bw, latency, memory_kind}}).

        Calibration measures tiers (compute->tier routes), not tier-to-tier
        links, so links are derived from the hub model: a transfer between
        two tiers stages through the compute endpoint, so it is limited by
        the slower route (min of read bandwidths) and pays *both* routes'
        latencies (their sum). This matches ``from_fabric``'s routed
        derivation whenever the fabric's tier-to-tier route actually passes
        through the reference compute node (every preset link except
        shortcut links like tpu_v5e's direct host->pool hop, where
        ``from_fabric``'s real route is faster)."""
        tiers = {k: MemoryTier(k, **v) for k, v in measurements.items()}
        links = {}
        names = sorted(tiers)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                links[(a, b)] = Link(a, b,
                                     min(tiers[a].read_bw, tiers[b].read_bw),
                                     tiers[a].latency + tiers[b].latency)
        return cls(tiers=tiers, links=links)

    @classmethod
    def from_fabric(cls, system) -> "TierTopology":
        """Derive a tier topology from a ``repro_torch.fabric.System``
        preset.

        Each mapped memory node becomes a tier whose bandwidth/latency are
        the *routed* path from the system's reference compute node; each
        tier pair gets a link with the routed bottleneck bandwidth — so the
        point-to-point consumers (cost model, placement) see fabric-accurate
        uncontended numbers on any of the paper's machines.
        """
        tiers, links = {}, {}
        for tier_name, node_name in system.tier_map.items():
            node = system.fabric.node(node_name)
            bw = system.fabric.route_bandwidth(system.compute, node_name)
            lat = system.fabric.route_latency(system.compute, node_name)
            tiers[tier_name] = MemoryTier(tier_name, node.capacity, bw, bw,
                                          lat, node.memory_kind)
        names = sorted(system.tier_map)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                na, nb = system.tier_map[a], system.tier_map[b]
                if na == nb:
                    continue
                links[(a, b)] = Link(a, b,
                                     system.fabric.route_bandwidth(na, nb),
                                     system.fabric.route_latency(na, nb))
        return cls(tiers=tiers, links=links)


# Tiers the port can place tensors in (what placement can use).
ADDRESSABLE = ("hbm", "host")
