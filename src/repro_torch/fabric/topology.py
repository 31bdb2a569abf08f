"""Interconnect fabric graph: devices, memories, and typed coherent links.

The port's copy of the reference's ``repro/fabric/topology.py``.

The paper's machines are *fabrics*, not point-to-point pairs: a CXL pool
hangs behind a switch shared by several hosts, a GH200's LPDDR sits across
NVLink-C2C, an MI300A's HBM is reached by CPU and GPU chiplets over the same
Infinity Fabric. This module models that as a graph of nodes (sockets,
accelerators, memories, switches) joined by typed links, with shortest-path
routing so every transfer has a *route* — the unit over which contention
(repro.fabric.contention) and the transfer simulator (repro.fabric.sim)
reason.

Links are directed internally; ``add_link`` installs both directions.
Full-duplex links (PCIe, CXL, NVLink-C2C, xGMI, ICI, DCN) give each
direction its own capacity; half-duplex links (a DDR command/data bus) pool
both directions onto one shared capacity — the source of the paper-style
"bidirectional fight" (§scenarios).
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Iterable, Optional


class LinkType(str, enum.Enum):
    DDR = "ddr"                  # socket <-> local DIMMs
    HBM = "hbm"                  # accelerator <-> stacked HBM
    UPI = "upi"                  # socket <-> socket (UPI / xGMI socket link)
    PCIE = "pcie"
    CXL = "cxl"                  # CXL.mem to an expander or switch
    NVLINK_C2C = "nvlink_c2c"    # Grace-Hopper chip-to-chip
    XGMI = "xgmi"                # AMD Infinity Fabric
    ICI = "ici"                  # TPU inter-chip interconnect
    DCN = "dcn"                  # data-center network (pooled/far tier)


class NodeKind(str, enum.Enum):
    COMPUTE = "compute"          # socket, GPU, TPU chip — flow endpoints
    MEMORY = "memory"            # DIMM, HBM stack, CXL expander/pool
    SWITCH = "switch"            # CXL switch, PCIe switch — routing only


@dataclasses.dataclass(frozen=True)
class FabricNode:
    name: str
    kind: NodeKind
    capacity: int = 0                    # bytes (memory nodes)
    memory_kind: Optional[str] = None    # jax memory kind if addressable


@dataclasses.dataclass(frozen=True)
class FabricLink:
    """One *direction* of a physical link."""
    src: str
    dst: str
    type: LinkType
    bandwidth: float             # bytes/s in this direction
    latency: float               # seconds, one traversal
    duplex: bool = True          # False: both directions share `bandwidth`

    @property
    def physical_id(self) -> tuple:
        """Identity of the underlying physical resource. Half-duplex links
        collapse both directions onto one id (shared capacity)."""
        if self.duplex:
            return (self.src, self.dst, self.type.value)
        return (*sorted((self.src, self.dst)), self.type.value)


# Half-duplex by default: a DDR bus is shared between reads and writes.
_HALF_DUPLEX_TYPES = frozenset({LinkType.DDR})


class FabricTopology:
    """Directed multigraph of nodes and typed links with latency routing."""

    def __init__(self, name: str = "fabric"):
        self.name = name
        self.nodes: dict[str, FabricNode] = {}
        self.links: dict[tuple, FabricLink] = {}     # (src, dst) -> link
        self._adj: dict[str, list[str]] = {}

    # -- construction -------------------------------------------------------
    def add_node(self, name: str, kind: NodeKind | str,
                 capacity: int = 0,
                 memory_kind: Optional[str] = None) -> FabricNode:
        node = FabricNode(name, NodeKind(kind), capacity, memory_kind)
        self.nodes[name] = node
        self._adj.setdefault(name, [])
        return node

    def add_link(self, src: str, dst: str, type: LinkType | str,
                 bandwidth: float, latency: float,
                 duplex: Optional[bool] = None) -> None:
        """Install the physical link src<->dst (both directions)."""
        if src not in self.nodes or dst not in self.nodes:
            missing = [n for n in (src, dst) if n not in self.nodes]
            raise ValueError(f"unknown node(s) {missing} for link "
                             f"{src}<->{dst}")
        lt = LinkType(type)
        if duplex is None:
            duplex = lt not in _HALF_DUPLEX_TYPES
        for a, b in ((src, dst), (dst, src)):
            self.links[(a, b)] = FabricLink(a, b, lt, bandwidth, latency,
                                            duplex)
            if b not in self._adj[a]:
                self._adj[a].append(b)

    def rescaled(self, scales: dict, name: Optional[str] = None
                 ) -> "FabricTopology":
        """New topology with per-link multiplicative scales applied.

        ``scales`` maps an *undirected* pair key ``(min(a,b), max(a,b))``
        to ``(bandwidth_factor, latency_factor)``; unlisted links keep
        their constants. Both directions of a physical link scale together
        (presets install symmetric constants; calibration measures the
        read direction and applies it to the pair). This is the primitive
        ``systems.from_profile`` rebuilds calibrated machines with.
        """
        out = FabricTopology(name or self.name)
        for n in self.nodes.values():
            out.add_node(n.name, n.kind, n.capacity, n.memory_kind)
        seen: set[tuple] = set()
        for (a, b), link in self.links.items():
            key = (min(a, b), max(a, b))
            if key in seen:
                continue
            seen.add(key)
            bw_f, lat_f = scales.get(key, (1.0, 1.0))
            if bw_f <= 0 or lat_f < 0:
                raise ValueError(f"bad scale {scales[key]} for link {key}: "
                                 "bandwidth factor must be > 0 and latency "
                                 "factor >= 0")
            out.add_link(a, b, link.type, link.bandwidth * bw_f,
                         link.latency * lat_f, duplex=link.duplex)
        return out

    def without_nodes(self, names: Iterable[str],
                      name: Optional[str] = None) -> "FabricTopology":
        """New topology with ``names`` (and every incident link) removed.

        The hot-removal primitive: a CXL expander pulled from the pool, a
        failed switch, a drained host. Complements ``rescaled`` — together
        they express every degradation the runtime injects (a link dropping
        to a fraction of its bandwidth, a tier disappearing outright).
        Removing an unknown node is an error; removing a node that leaves a
        memory tier unreachable is legal — ``validate()`` is the caller's
        check if full reachability is required.
        """
        gone = set(names)
        missing = sorted(gone - set(self.nodes))
        if missing:
            raise ValueError(f"cannot remove unknown node(s) {missing} "
                             f"from {self.name}; have {sorted(self.nodes)}")
        out = FabricTopology(name or self.name)
        for n in self.nodes.values():
            if n.name not in gone:
                out.add_node(n.name, n.kind, n.capacity, n.memory_kind)
        seen: set[tuple] = set()
        for (a, b), link in self.links.items():
            key = (min(a, b), max(a, b))
            if key in seen or a in gone or b in gone:
                continue
            seen.add(key)
            out.add_link(a, b, link.type, link.bandwidth, link.latency,
                         duplex=link.duplex)
        return out

    # -- queries ------------------------------------------------------------
    def node(self, name: str) -> FabricNode:
        if name not in self.nodes:
            raise ValueError(f"unknown node {name!r}; have "
                             f"{sorted(self.nodes)}")
        return self.nodes[name]

    def link(self, src: str, dst: str) -> FabricLink:
        try:
            return self.links[(src, dst)]
        except KeyError:
            raise ValueError(f"no link {src}->{dst} in {self.name}") from None

    def neighbors(self, name: str) -> list[str]:
        return list(self._adj.get(name, []))

    def memory_nodes(self) -> list[FabricNode]:
        return [n for n in self.nodes.values() if n.kind is NodeKind.MEMORY]

    # -- routing ------------------------------------------------------------
    def route(self, src: str, dst: str) -> list[FabricLink]:
        """Shortest path src->dst minimizing total latency (ties: hops).

        Returns the list of directed links along the path ([] if src==dst).
        """
        self.node(src), self.node(dst)
        if src == dst:
            return []
        # Dijkstra on (latency, hops).
        dist: dict[str, tuple] = {src: (0.0, 0)}
        prev: dict[str, str] = {}
        heap = [(0.0, 0, src)]
        seen: set[str] = set()
        while heap:
            d, h, u = heapq.heappop(heap)
            if u in seen:
                continue
            seen.add(u)
            if u == dst:
                break
            for v in self._adj[u]:
                link = self.links[(u, v)]
                nd, nh = d + link.latency, h + 1
                if v not in dist or (nd, nh) < dist[v]:
                    dist[v] = (nd, nh)
                    prev[v] = u
                    heapq.heappush(heap, (nd, nh, v))
        if dst not in prev:
            raise ValueError(f"no route {src}->{dst} in {self.name}")
        path = [dst]
        while path[-1] != src:
            path.append(prev[path[-1]])
        path.reverse()
        return [self.links[(a, b)] for a, b in zip(path, path[1:])]

    def route_bandwidth(self, src: str, dst: str) -> float:
        """Contention-free bandwidth of the route: min link bandwidth."""
        route = self.route(src, dst)
        if not route:
            return float("inf")
        return min(l.bandwidth for l in route)

    def route_latency(self, src: str, dst: str) -> float:
        return sum(l.latency for l in self.route(src, dst))

    def validate(self) -> None:
        """Every memory node must be reachable from every compute node."""
        computes = [n.name for n in self.nodes.values()
                    if n.kind is NodeKind.COMPUTE]
        for c in computes:
            for m in self.memory_nodes():
                self.route(c, m.name)


def route_key(route: Iterable[FabricLink]) -> tuple:
    """Hashable identity of a route (sequence of directed links)."""
    return tuple((l.src, l.dst) for l in route)
