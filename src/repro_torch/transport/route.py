"""Routes: resolved fabric paths with provenance, and the tier probe.

The port's copy of the reference's ``repro/transport/route.py``.

A ``Route`` pins down everything a byte-moving layer needs to cost a
transfer: the resolved endpoint *nodes* (tier names accepted when resolved
against a ``System``), the directed links along the shortest-latency path,
the bottleneck bandwidth and summed hop latency, and where those constants
came from (``"nominal"`` datasheet presets vs a ``"calibrated"`` fit from
``repro.calibrate``). Costing methods mirror the cost model's historical
contract exactly — ``transfer_time`` is the closed uncontended form,
``contended_transfer_time`` the max-min fair steady state (``inf`` when
starved by higher-priority traffic).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.fabric.topology import FabricTopology

PROVENANCE_NOMINAL = "nominal"
PROVENANCE_CALIBRATED = "calibrated"


@dataclasses.dataclass(frozen=True)
class Route:
    """A resolved src->dst path through one fabric.

    Build via ``Route.resolve(system_or_fabric, src, dst)`` — against a
    ``System`` the endpoints may be tier names (``"host"``) or node names;
    against a bare ``FabricTopology`` they must be node names. ``src_name``
    / ``dst_name`` keep the caller's vocabulary for labels and errors.
    """
    fabric: FabricTopology
    src: str                              # resolved fabric node
    dst: str
    links: tuple                          # directed FabricLinks on the path
    provenance: str = PROVENANCE_NOMINAL
    system: Optional[object] = None       # owning System, for flow resolution
    src_name: str = ""                    # endpoint as the caller named it
    dst_name: str = ""

    @classmethod
    def resolve(cls, system_or_fabric, src: str, dst: str) -> "Route":
        """Resolve endpoints and path; raises ``ValueError`` when the
        endpoint is unknown or no route survives (e.g. a hot-removed
        tier)."""
        obj = system_or_fabric
        if hasattr(obj, "tier_node"):     # a fabric.systems.System
            s, d = obj.tier_node(src), obj.tier_node(dst)
            fab, sysref = obj.fabric, obj
            prov = getattr(obj, "provenance", PROVENANCE_NOMINAL)
        else:                             # a bare FabricTopology
            fab, s, d, sysref = obj, src, dst, None
            prov = (PROVENANCE_CALIBRATED
                    if obj.name.endswith("+calibrated")
                    else PROVENANCE_NOMINAL)
        links = tuple(fab.route(s, d))
        return cls(fab, s, d, links, prov, sysref, src, dst)

    @classmethod
    def try_resolve(cls, system_or_fabric, src: str,
                    dst: str) -> Optional["Route"]:
        """``resolve`` that returns None instead of raising — the tolerant
        form degraded-fabric callers want ("this route contributes
        nothing")."""
        try:
            return cls.resolve(system_or_fabric, src, dst)
        except ValueError:
            return None

    # -- derived constants ----------------------------------------------------
    @property
    def bottleneck_bw(self) -> float:
        """Bandwidth of the narrowest link on the path (inf for a
        zero-hop route: src == dst)."""
        return min((l.bandwidth for l in self.links), default=math.inf)

    @property
    def latency(self) -> float:
        """Summed unloaded one-way hop latency (s)."""
        return sum(l.latency for l in self.links)

    @property
    def label(self) -> str:
        """Stable ``src->dst`` string for metrics labels and reports."""
        return f"{self.src}->{self.dst}"

    def _resolve_flows(self, flows: Sequence) -> list:
        """Rewrite tier-named flow endpoints to node names when this route
        was resolved against a System (node-named flows pass through)."""
        if self.system is not None:
            return self.system.resolve_flows(flows)
        return list(flows)

    # -- costing --------------------------------------------------------------
    def effective_bandwidth(self, background: Sequence = (), *,
                            weight: float = 1.0,
                            priority: int = 0) -> float:
        """Max-min fair rate a flow of this QoS class gets on this route
        alongside ``background`` (0.0 when priority-starved)."""
        from repro_torch.fabric.contention import effective_bandwidth
        return effective_bandwidth(self.fabric, self.src, self.dst,
                                   self._resolve_flows(background),
                                   weight=weight, priority=priority)

    def transfer_time(self, nbytes: float, *,
                      compression: float = 1.0) -> float:
        """Uncontended transfer duration: wire bytes over the bottleneck
        plus summed hop latency. ``nbytes`` is the logical size; the wire
        carries ``nbytes / compression``."""
        if compression <= 0:
            raise ValueError(f"compression must be > 0, got {compression}")
        return nbytes / compression / self.bottleneck_bw + self.latency

    def contended_transfer_time(self, nbytes: float,
                                background: Sequence = (), *,
                                compression: float = 1.0,
                                weight: float = 1.0,
                                priority: int = 0) -> float:
        """Steady-state duration alongside background traffic at the given
        DMA QoS class; ``inf`` when the class is starved (it never
        completes)."""
        if compression <= 0:
            raise ValueError(f"compression must be > 0, got {compression}")
        bw = self.effective_bandwidth(background, weight=weight,
                                      priority=priority)
        if bw <= 0:
            return math.inf
        return nbytes / compression / bw + self.latency


def probe_tier_bandwidths(system, background: Sequence = (), *,
                          weight: float = 1.0, priority: int = 0,
                          tiers: Optional[Sequence] = None,
                          tolerant: bool = False) -> dict:
    """Contended tier->compute read bandwidths — the one probe placement
    and the elastic replanner share.

    Probes each tier's node->compute route with QoS-aware max-min fair
    sharing against ``background``. ``tiers`` defaults to every mapped
    tier. ``tolerant=True`` is the degraded-fabric form: a tier whose node
    was hot-removed, left unreachable, or named by an unresolvable
    background flow reports 0.0 instead of raising — "this tier
    contributes nothing" is exactly the replanner's signal. The strict
    form (default) propagates ``ValueError`` so planning on a healthy
    fabric fails loudly on a typo.
    """
    from repro_torch.fabric.contention import effective_bandwidth

    names = list(system.tier_map) if tiers is None else list(tiers)
    try:
        bg = system.resolve_flows(background)
    except ValueError:          # a background flow named a removed tier
        if not tolerant:
            raise
        bg = []
    out = {}
    for tier in names:
        node = system.tier_map.get(tier)
        if node is None or node not in system.fabric.nodes:
            if tolerant:
                out[tier] = 0.0
                continue
            node = system.tier_node(tier)   # raises with the full context
        try:
            out[tier] = effective_bandwidth(system.fabric, node,
                                            system.compute, bg,
                                            weight=weight,
                                            priority=priority)
        except ValueError:      # no route survives the degradation
            if not tolerant:
                raise
            out[tier] = 0.0
    return out
